"""The port's safetensors writer and checkpoints (ocrjax_torch/weights.py,
ocrjax_torch/train/checkpoint.py).

  * save_variables from the port, read by ocrjax.weights.load_variables:
    the JAX models then give the port's outputs (CRNN, DB, cls with random
    weights and BatchNorm statistics; float32, 1e-5);
  * the shipped assets written back by the port into a directory load in
    both packages' from_pretrained and read a page alike;
  * the charset sidecar and the metadata round trip;
  * a checkpoint written after step 1 and loaded into a fresh model and
    optimizer continues to the uninterrupted run's losses and weights,
    bit for bit; latest_checkpoint picks the highest step.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrjax import weights as JW
from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.charset import Charset as JaxCharset
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.config import TINY as JAX_TINY
from ocrjax.models.cls import create_cls as jax_cls
from ocrjax.models.crnn import create_crnn as jax_crnn
from ocrjax.models.db import DB_ARCHS, create_db_arch
from ocrjax_torch import weights as W
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.charset import Charset
from ocrjax_torch.config import TINY
from ocrjax_torch.models.cls import create_cls
from ocrjax_torch.models.crnn import create_crnn
from ocrjax_torch.models.db import create_db
from ocrjax_torch.train import checkpoint as C
from ocrjax_torch.train import rec_trainer as R
from ocrjax_torch.train import synth
from test_torch_fixture import few_torch_threads  # noqa: F401
from test_torch_slice import _page

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _randomize(model, seed):
    """Random weights and BatchNorm statistics (init_random_'s BN is the
    identity, which would not show a swapped mean and variance)."""
    W.init_random_(model, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.3)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return model.eval()


def _written(tmp_path, model, name):
    path = str(tmp_path / f"{name}.safetensors")
    W.save_variables(path, W.model_variables(model), {"kind": name})
    return JW.load_variables(path)


def test_crnn_written_by_the_port_runs_in_ocrjax(tmp_path):
    port = _randomize(create_crnn(TINY, 11), 0)
    variables = _written(tmp_path, port, "rec")
    x = np.random.RandomState(0).randn(3, 32, 64).astype(np.float32)
    widths = np.array([64, 40, 9], np.int32)
    want, wl = jax_crnn(JAX_TINY, 11).apply(
        variables, jnp.asarray(x[..., None]), jnp.asarray(widths))
    with torch.no_grad():
        got, gl = port(torch.from_numpy(x[:, None]), torch.from_numpy(widths))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    for b, n in enumerate(np.asarray(wl)):     # the valid frames
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(want)[b, :n], atol=1e-5)


@pytest.mark.parametrize("hs", [1, 4])
def test_db_written_by_the_port_runs_in_ocrjax(tmp_path, hs):
    arch = dict(DB_ARCHS["tile"], head_stride=hs)
    port = _randomize(create_db(TINY, arch), 1)
    variables = _written(tmp_path, port, "det")
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    want = create_db_arch(JAX_TINY, arch).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got["prob"].numpy(), np.asarray(want["prob"]),
                               atol=1e-5)


def test_cls_written_by_the_port_runs_in_ocrjax(tmp_path):
    port = _randomize(create_cls(TINY), 2)
    variables = _written(tmp_path, port, "cls")
    x = np.random.RandomState(2).randn(3, 32, 96).astype(np.float32)
    widths = np.array([96, 50, 7], np.int32)
    want = jax_cls(JAX_TINY).apply(variables, jnp.asarray(x[..., None]),
                                   jnp.asarray(widths))
    with torch.no_grad():
        got = port(torch.from_numpy(x[:, None]), torch.from_numpy(widths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_shipped_assets_written_back_load_in_both_packages(tmp_path):
    cfg = asset_config(det_max_side=512, compute_dtype="float32")
    src = OcrEngine.from_pretrained(config=cfg, device="cpu")
    d = str(tmp_path / "assets")
    metas = {n: W.read_safetensors(os.path.join(ROOT, "assets",
                                                f"{n}.safetensors"))[1]
             for n in ("rec", "det", "cls", "det_tile")}
    for name, model in (("rec", src.rec_model), ("det", src.det_model),
                        ("cls", src.cls_model),
                        ("det_tile", src.tile_det_model)):
        W.save_variables(os.path.join(d, f"{name}.safetensors"),
                         W.model_variables(model), metas[name])
    W.save_charset_sidecar(os.path.join(d, "rec.safetensors"), src.charset)
    port = OcrEngine.from_pretrained(d, config=cfg, device="cpu")
    jax_engine = JaxEngine.from_pretrained(
        d, config=JaxConfig(**dataclasses.asdict(cfg)))
    assert port.cls_antisym == src.cls_antisym
    assert port.tile_det_arch == src.tile_det_arch
    page = _page(7)
    got, want, ref = port.ocr(page), jax_engine.ocr(page), src.ocr(page)
    texts = [line.text for line in want.lines]
    assert [line.text for line in got.lines] == texts and texts
    assert [line.text for line in ref.lines] == texts


def test_charset_sidecar_and_metadata_round_trip(tmp_path):
    cs = Charset("ab_c9 ")
    path = str(tmp_path / "m" / "rec.safetensors")
    W.save_variables(path, {"params": {"x": np.arange(6, dtype=np.int32)}},
                     {"config": json.dumps({"rec_hidden": 160}), "step": 7})
    assert W.load_metadata(path) == JW.load_metadata(path) == {
        "config": '{"rec_hidden": 160}', "step": "7"}
    side = W.save_charset_sidecar(path, cs)
    assert side == str(tmp_path / "m" / "rec.charset.txt")
    assert JaxCharset.from_file(side).chars == cs.chars
    assert Charset.from_file(side).chars == cs.chars
    np.testing.assert_array_equal(
        np.asarray(JW.load_variables(path)["params"]["x"]), np.arange(6))


def _rec_batches(n):
    cs = Charset("abcdefghij")
    rng = np.random.RandomState(4)
    return cs, [synth.make_line_batch(rng, cs, 4, 64, 32, max_len=4)
                for _ in range(n)]


def _run(model, opt, batches):
    step = R.make_train_step(model, opt)
    return [float(step(*(torch.from_numpy(np.asarray(a)) for a in (
        b.images, b.widths, b.labels, b.label_lengths)))) for b in batches]


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    cs, batches = _rec_batches(3)
    ref = _randomize(create_crnn(TINY, cs.num_classes), 5)
    start = W.model_variables(ref)
    full = _run(ref, R.rec_optimizer(ref, 1e-3, 20), batches)

    a = create_crnn(TINY, cs.num_classes)
    W.load_model_variables(a, start)
    opt_a = R.rec_optimizer(a, 1e-3, 20)
    first = _run(a, opt_a, batches[:1])
    path = str(tmp_path / "ck" / "rec_1.safetensors")
    C.save_train_state(path, 1, a, opt_a)
    b = _randomize(create_crnn(TINY, cs.num_classes), 99)   # other weights
    opt_b = R.rec_optimizer(b, 1e-3, 20)
    assert C.load_train_state(path, b, opt_b) == 1
    rest = _run(b, opt_b, batches[1:])
    assert first + rest == full
    got, want = W.model_variables(b), W.model_variables(ref)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # params and BN statistics in flax's layout: ocrjax reads them
    tree = JW.load_variables(path)
    assert set(tree) == {"params", "batch_stats", "opt"}


def test_latest_checkpoint(tmp_path):
    d = str(tmp_path)
    model = create_crnn(TINY, 4)
    opt = R.rec_optimizer(model, 1e-3, 10)
    for s in (100, 300, 200):
        C.save_train_state(f"{d}/rec_{s}.safetensors", s, model, opt)
    assert C.latest_checkpoint(d, "rec_").endswith("rec_300.safetensors")
    assert C.latest_checkpoint(d, "det_") is None
    assert C.latest_checkpoint("/nonexistent", "rec_") is None
