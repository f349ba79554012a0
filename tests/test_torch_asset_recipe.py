"""A 20-step TINY rec recipe, every augmentation of
scripts/finetune_r5_soft.sh on, from one flax init, through the reference's
scripts/train_rec_assets.py and the port's ocrjax_torch.scripts
.train_rec_assets on the CPU (chip_smoke.run_script: every step logged, the
first invocation ending right after its checkpoint at step 10 and a second
resuming there): the same batches, the losses of every step at the TINY
step bar of test_torch_train_rec.py, the same eval."""

import numpy as np

import chip_smoke as CS
from test_torch_asset_scripts import _port
from test_torch_fixture import (few_torch_threads,  # noqa: F401
                                jax_modules, no_jax_disk_cache,
                                reference_script)
from test_torch_train_rec import LOSS_RTOL


def test_tiny_rec_recipe_resumes_and_matches_ocrjax(tmp_path):
    """20 steps of a TINY rec recipe with its augmentations, from one
    flax init, the first invocation ending after its checkpoint at step
    10 and a second resuming there, in both packages."""
    import jax
    import jax.numpy as jnp
    from ocrjax import weights as JW
    from ocrjax.charset import default_charset
    from ocrjax.config import TINY as JAX_TINY
    from ocrjax.models.crnn import create_crnn
    init = str(tmp_path / "init.safetensors")
    JW.save_variables(init, create_crnn(
        JAX_TINY, default_charset().num_classes).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 1))))
    argv = ["--finetune-from", init, "--steps", "20", "--batch", "8",
            "--width", "96", "--max-len", "6", "--hidden", "48",
            "--channels", "16,32,48,64", "--lr", "1e-3", "--p-word", "0.25",
            "--p-space", "0.06", "--aug-rotation", "4", "--quantize-p",
            "0.5", "--stretch", "0.15", "--confusable-bias", "2",
            "--font-bias", "DejaVuSans.ttf:2", "--font-anneal-frac", "0.25",
            "--degrade", "0.45", "--degrade-anneal-frac", "0.1",
            "--flat-snap", "0.3", "--ent-reg", "0.03"]
    runs = []
    for tag, mods, main, extra in (
            ("ref", jax_modules(), reference_script("train_rec_assets").main, []),
            ("port", CS.port_modules(), _port("train_rec_assets").main,
             ["--cpu"])):
        a = argv + ["--ckpt-dir", str(tmp_path / f"{tag}_ck"), "--out",
                    str(tmp_path / f"{tag}.safetensors"), *extra]
        with no_jax_disk_cache():
            first = CS.run_script(mods, main, a, "rec", ckpt_every=10,
                                  stop_at=10)
            second = CS.run_script(mods, main, a, "rec", ckpt_every=10,
                                   first_step=11)
        assert len(first["losses"]) == 10 and "result" not in first
        runs.append({"losses": first["losses"] + second["losses"],
                     "digests": first["digests"] + second["digests"],
                     "result": second["result"]})
    got, want = runs[1], runs[0]
    assert [s for s, _ in want["losses"]] == list(range(1, 21))
    assert got["digests"] == want["digests"]
    np.testing.assert_allclose([v for _, v in got["losses"]],
                               [v for _, v in want["losses"]],
                               rtol=LOSS_RTOL)
    assert got["result"] == want["result"]
