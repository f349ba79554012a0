"""The port's asset scripts (ocrjax_torch/scripts/) against the reference's
(scripts/*.py), on the CPU:

  * for each shipped recipe's flags (and a few variants), both main()s pass
    equal kwargs to their trainer and to generate_det_crops (the trainers
    and generate_det_crops are capturing stubs here); the port adds only
    device="cpu" for --cpu;
  * soup_weights of two random checkpoints: both soups bit-equal, metadata
    included;
  * eval_multiseed with every tier (--degrade --projective) at 1 seed x 2
    pages a tier, float32: the port's JSON equals ocrjax's.
test_torch_asset_recipe.py runs a TINY rec recipe through both scripts.
"""

import dataclasses
import importlib
import json
import os
import sys

import numpy as np
import pytest

import chip_smoke as CS
from test_torch_fixture import (few_torch_threads,  # noqa: F401
                                jax_modules, no_jax_disk_cache,
                                reference_script)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
def _port(name):
    return importlib.import_module(f"ocrjax_torch.scripts.{name}")


def _recipe(path):
    """The flags a recipe shell script passes its python script."""
    with open(os.path.join(ROOT, "scripts", path)) as f:
        text = f.read().replace("\\\n", " ")
    line = next(x for x in text.splitlines() if x.startswith("python "))
    return [a for a in line.split()[2:] if a != '"$@"']


def test_recipes_are_the_shell_scripts():
    """chip_smoke's recipes are the shipped shell scripts' flags but their
    /tmp checkpoint and output paths."""
    for path, recipe in (("finetune_r5_soft.sh", CS.REC_RECIPE),
                         ("finetune_r3_det.sh", CS.DET_RECIPE)):
        argv = _recipe(path)
        for flag in ("--ckpt-dir", "--out"):
            i = argv.index(flag)
            del argv[i:i + 2]
        assert argv == recipe


class _Result:
    """What a trainer stub returns: every result field the scripts read."""
    variables = {"params": {"w": np.zeros((2,), np.float32)}}
    exact_match = recall = precision = accuracy = 0.5


def _plain(v):
    """A kwarg's value in a form both packages' values compare in."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if callable(v) and not hasattr(v, "config"):
        return "<callable>"
    if hasattr(v, "config") and hasattr(v, "charset"):      # an OcrEngine
        return {"config": _plain(v.config),
                "charset": list(v.charset.chars)}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "chars"):                                  # a Charset
        return list(v.chars)
    if isinstance(v, dict) and v and isinstance(next(iter(v.values())),
                                                dict):
        from ocrjax_torch.weights import flatten
        v = flatten(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if hasattr(v, "shape"):
        return np.asarray(v).tolist()
    return v


def _captured(mods, kind, main, argv, monkeypatch):
    """main(argv) with the trainer and generate_det_crops as stubs;
    -> (trainer kwargs, generate_det_crops kwargs or None)."""
    got = {}

    def trainer(**kw):
        got["train"] = kw
        return _Result()

    def crops(engine, **kw):
        got["crops"] = dict(kw, engine=engine)
        return mods["det_crops"].DetCropSet(
            np.zeros((3, 32, 8), np.uint8), np.full((3,), 8, np.int32),
            ["a", "b", "c"])
    monkeypatch.setattr(mods[f"{kind}_trainer"], f"train_{kind}", trainer)
    monkeypatch.setattr(mods["det_crops"], "generate_det_crops", crops)
    monkeypatch.setattr(sys, "argv", [kind] + argv)
    with no_jax_disk_cache():
        main()
    return got["train"], got.get("crops")


REC_VARIANTS = [
    CS.REC_RECIPE,
    ["--steps", "7", "--font-bias", "Mono:3,DejaVuSerif.ttf:0.5",
     "--rec-height", "48", "--hidden", "96", "--channels", "16,32,48,64"],
    ["--confusable-bias", "1.5", "--finetune-from",
     os.path.join(ROOT, "assets", "rec.safetensors"), "--quantize-p", "1"],
]
DET_VARIANTS = [CS.DET_RECIPE, ["--arch", "tile", "--size", "256",
                                "--head-stride", "4"]]
CLS_VARIANTS = [[], ["--widths", "64", "192", "--crop-pages", "3",
                     "--antisym", "0"]]


@pytest.mark.parametrize("kind,argv", [
    *(("rec", a) for a in REC_VARIANTS), *(("det", a) for a in DET_VARIANTS),
    *(("cls", a) for a in CLS_VARIANTS)])
def test_scripts_pass_the_references_kwargs(kind, argv, tmp_path,
                                            monkeypatch):
    name = f"train_{kind}_assets"
    out = ["--out", str(tmp_path / f"{kind}.safetensors")]
    want, want_crops = _captured(jax_modules(), kind, reference_script(name).main,
                                 argv + out, monkeypatch)
    got, got_crops = _captured(CS.port_modules(), kind, _port(name).main,
                               argv + out + ["--cpu"], monkeypatch)
    assert got.pop("device") == "cpu"
    assert set(got) == set(want)
    for k in want:
        a, b = _plain(got[k]), _plain(want[k])
        assert a == b, k
    assert (got_crops is None) == (want_crops is None)
    if want_crops:
        assert _plain(got_crops) == _plain(want_crops)


def test_soup_weights_equals_the_references(tmp_path):
    from safetensors import safe_open
    from safetensors.numpy import save_file
    rng = np.random.RandomState(0)
    shapes = {"params/a/kernel": (3, 4), "params/b/bias": (5,),
              "batch_stats/c/mean": (2, 2)}
    paths = []
    for i in range(2):
        tensors = {k: rng.randn(*s).astype(np.float32)
                   for k, s in shapes.items()}
        tensors["params/h"] = rng.randn(3).astype(np.float16)
        paths.append(str(tmp_path / f"ck{i}.safetensors"))
        save_file(tensors, paths[-1], metadata={"kind": "crnn",
                                                "steps": str(10 * i)})
    soups = []
    for tag, main in (("ref", reference_script("soup_weights").main),
                      ("port", _port("soup_weights").main)):
        out = str(tmp_path / f"soup_{tag}.safetensors")
        sys_argv = sys.argv
        sys.argv = ["soup", *paths, out, "--alpha", "0.3"]
        try:
            main()
        finally:
            sys.argv = sys_argv
        with safe_open(out, framework="np") as f:
            soups.append(({k: f.get_tensor(k) for k in f.keys()},
                          f.metadata()))
    (a, ma), (b, mb) = soups
    assert ma == mb and json.loads(ma["soup"])["alpha"] == 0.3
    assert ma["steps"] == "10"
    assert set(a) == set(b) == set(shapes) | {"params/h"}
    for k in a:
        assert a[k].dtype == b[k].dtype
        assert a[k].tobytes() == b[k].tobytes(), k


def test_eval_multiseed_equals_the_references(tmp_path, monkeypatch):
    """Every tier at 1 seed x 2 pages, float32, the shipped assets."""
    from ocrjax.train import e2e_eval as je
    from ocrjax_torch.train import e2e_eval as pe
    for mod in (je, pe):
        orig = mod.evaluate_e2e
        monkeypatch.setattr(mod, "evaluate_e2e", lambda engine, n_pages, _o=
                            orig, **kw: _o(engine, n_pages=2, **kw))
    argv = ["--degrade", "--projective", "--straight-seeds", "1",
            "--rotated-seeds", "1", "--degrade-seeds", "1", "--json"]
    outs = []
    for tag, mods, main, extra in (
            ("ref", jax_modules(), reference_script("eval_multiseed").main, []),
            ("port", CS.port_modules(), _port("eval_multiseed").main,
             ["--cpu"])):
        js = str(tmp_path / f"{tag}.json")
        with no_jax_disk_cache():
            CS.run_script(mods, main, argv + [js] + extra)
        with open(js) as f:
            outs.append(json.load(f))
    assert list(outs[0]) == ["straight", "rotated", "heldout_renderer",
                             "degraded_0.25", "degraded_0.5",
                             "degraded_0.75", "degraded_1.0",
                             "projective_0.3", "projective_0.6",
                             "projective_1.0"]
    assert outs[1] == outs[0]
