"""Import hygiene and the device default of ocrjax_torch: no module of the
port (its CLI and scripts included), and not chip_smoke.py, imports JAX,
ocrjax or the repository's reference scripts/;
importing the API or the CLI pulls neither in; the engine refuses to run without CUDA unless asked for the
CPU; its config has exactly ocrjax's fields and defaults."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ocrjax")
# the port's copies of the reference's scripts/ (ocrjax_torch/scripts/)
PORT_SCRIPTS = ("train_rec_assets", "train_det_assets", "train_cls_assets",
                "soup_weights", "eval_multiseed", "eval_quality_breakdown",
                "eval_xheight", "eval_beam", "bench_int8_det",
                "bench_try_flip", "eval_tiled_quality", "probe_dense",
                "calibrate_unclip")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_ocrjax_imports():
    files = glob.glob(os.path.join(ROOT, "ocrjax_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 10
    names = {os.path.relpath(f, ROOT) for f in files}
    assert {"ocrjax_torch/api_det.py", "ocrjax_torch/bucketing.py",
            "ocrjax_torch/bench_conv.py", "ocrjax_torch/tiling.py",
            "ocrjax_torch/ops/conv_fused.py", "ocrjax_torch/cli.py",
            "ocrjax_torch/imageio.py",
            "ocrjax_torch/models/db_int8.py", "ocrjax_torch/bench_lib.py",
            "ocrjax_torch/utils/roofline.py",
            "ocrjax_torch/train/synth.py", "ocrjax_torch/train/optim.py",
            "ocrjax_torch/train/rec_trainer.py",
            "ocrjax_torch/train/det_trainer.py",
            "ocrjax_torch/train/cls_trainer.py",
            "ocrjax_torch/train/det_crops.py",
            "ocrjax_torch/train/e2e_eval.py",
            "ocrjax_torch/parallel/mesh.py", "ocrjax_torch/parallel/dryrun.py",
            "ocrjax_torch/utils/logging.py",
            "ocrjax_torch/postprocess/host_boxes.py",
            "ocrjax_torch/postprocess/native_boxes.py",
            "ocrjax_torch/bench_main.py",
            "ocrjax_torch/scripts/__init__.py"} <= names
    assert {f"ocrjax_torch/scripts/{n}.py" for n in PORT_SCRIPTS} <= names
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN + ("scripts",)]
    assert not bad


def test_port_scripts_import_no_reference_script():
    """Every file of ocrjax_torch/scripts/ imports nothing of JAX, ocrjax
    or the reference's scripts/: a helper it needs is copied into it."""
    files = glob.glob(os.path.join(ROOT, "ocrjax_torch", "scripts", "*.py"))
    assert {os.path.basename(f)[:-3] for f in files} == \
        set(PORT_SCRIPTS) | {"__init__"}
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & set(FORBIDDEN + ("scripts",)), (f, roots)


def test_api_import_pulls_in_no_jax():
    code = ("import sys, ocrjax_torch.api, ocrjax_torch.fused, "
            "ocrjax_torch.api_det, ocrjax_torch.bucketing, "
            "ocrjax_torch.bench_conv, ocrjax_torch.ops.conv_fused, "
            "ocrjax_torch.tiling, ocrjax_torch.cli, ocrjax_torch.imageio, "
            "ocrjax_torch.models.db_int8, ocrjax_torch.bench_lib, "
            "ocrjax_torch.train.rec_trainer, ocrjax_torch.train.det_trainer, "
            "ocrjax_torch.train.cls_trainer, ocrjax_torch.train.det_crops, "
            "ocrjax_torch.train.e2e_eval, ocrjax_torch.train.checkpoint, "
            "ocrjax_torch.parallel.mesh, ocrjax_torch.parallel.dryrun, "
            "ocrjax_torch.utils.logging, ocrjax_torch.postprocess.host_boxes, "
            "ocrjax_torch.postprocess.native_boxes, ocrjax_torch.bench_main, "
            + ", ".join(f"ocrjax_torch.scripts.{n}" for n in PORT_SCRIPTS)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('scripts',)!r}]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr


def test_engine_defaults_to_cuda():
    from ocrjax_torch.api import OcrEngine
    from ocrjax_torch.config import TINY
    if torch.cuda.is_available():
        assert OcrEngine(config=TINY).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            OcrEngine(config=TINY)
    assert OcrEngine(config=TINY, device="cpu").device.type == "cpu"


def test_config_mirrors_ocrjax():
    from ocrjax.config import TINY as JAX_TINY, OcrConfig as JaxConfig
    from ocrjax_torch.config import TINY, OcrConfig
    assert [(f.name, f.default) for f in dataclasses.fields(OcrConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert dataclasses.asdict(TINY) == dataclasses.asdict(JAX_TINY)
