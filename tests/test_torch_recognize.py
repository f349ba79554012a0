"""Strip recognition (recognize / recognize_strips) and the host
preprocessing it and the staged lanes rest on, against ocrjax and cv2.

The resizes are held bit-exact: resize_linear_u8 reproduces cv2's
fixed-point INTER_LINEAR for uint8, decode_canvas_luma_first the
reference's native canvas decode. Strings are held identical, confidences
to 1e-5 (float32 CRNN in two frameworks).
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrjax import preprocess as jpre
from ocrjax.api import OcrEngine as JaxEngine
from ocrjax.config import OcrConfig as JaxConfig
from ocrjax.train import synth
from ocrjax_torch import preprocess as tpre
from ocrjax_torch.api import OcrEngine, asset_config
from ocrjax_torch.config import OcrConfig
from test_torch_fixture import few_torch_threads, jax_fields  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIP_SEEDS = [301, 302, 303, 304, 305, 306, 307, 308]


def _blurred(rng, shape):
    img = rng.randint(0, 256, shape).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5)


@pytest.mark.parametrize("seed", range(6))
def test_resize_linear_u8_is_cv2_bit_for_bit(seed):
    """Random and blurred images, grey and RGB, scaling up and down,
    including the exact 2:1 downscale where cv2 averages 2x2 boxes."""
    rng = np.random.RandomState(seed)
    for t in range(40):
        h, w = rng.randint(1, 160, 2)
        nh, nw = rng.randint(1, 160, 2)
        if t % 5 == 0:
            nh, nw = max(1, h // 2), max(1, w // 2)
            h, w = 2 * nh, 2 * nw
        shape = (h, w) if t % 2 else (h, w, 3)
        img = _blurred(rng, shape) if t % 3 == 0 else \
            rng.randint(0, 256, shape).astype(np.uint8)
        want = cv2.resize(img, (int(nw), int(nh)),
                          interpolation=cv2.INTER_LINEAR)
        got = tpre.resize_linear_u8(img, (int(nh), int(nw)))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{shape}->{nh, nw}")


@pytest.mark.parametrize("shape", [(20, 113), (32, 129), (48, 139),
                                   (64, 419), (11, 7), (97, 1200)])
def test_rec_resize_matches_ocrjax(shape):
    img = _blurred(np.random.RandomState(shape[0]), shape)
    want = jpre.rec_resize(img, 32)
    got = tpre.rec_resize(img, 32)
    assert got.shape == want.shape and got.shape[0] == 32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(300, 200, 3), (140, 333), (128, 128, 3),
                                   (96, 80, 3)])
def test_canvas_decodes_match_ocrjax_bit_for_bit(shape):
    """Both canvas routes: RGB-first through cv2's resize, and luma-first as
    the reference's native decode computes it."""
    img = _blurred(np.random.RandomState(3), shape)
    cfg, jcfg = OcrConfig(det_max_side=128), JaxConfig(det_max_side=128)
    rgb = tpre.load_image(img)
    want, ws, wv = jpre.det_resize_to_canvas(rgb, jcfg)
    got, gs, gv = tpre.det_resize_to_canvas(rgb, cfg)
    assert (gs, tuple(gv)) == (ws, tuple(wv))
    np.testing.assert_array_equal(got, want)

    native = jpre.decode_canvas_native(img, jcfg)
    if native is None:
        pytest.skip("ocrjax's native library did not build on this host")
    gray, scale, hw, frac = tpre.decode_canvas_luma_first(img, cfg)
    assert (scale, tuple(hw)) == (native[1], tuple(native[2]))
    np.testing.assert_array_equal(gray, native[0])
    assert frac == pytest.approx(native[3])
    if max(shape[:2]) <= 128:       # no resample: both routes agree
        np.testing.assert_array_equal(gray, tpre.to_gray(got))


def test_decode_chunk_to_gray_matches_ocrjax():
    rng = np.random.RandomState(5)
    dark = np.full((90, 70), 12, np.uint8)
    dark[20:30, 10:60] = 230
    colour = np.full((100, 120, 3), 255, np.uint8)
    colour[30:60, 20:100, 2] = 0
    images = [_blurred(rng, (200, 150, 3)), dark, colour,
              _blurred(rng, (64, 64)), np.zeros((4, 4), np.float32)]
    cfg, jcfg = OcrConfig(det_max_side=128), JaxConfig(det_max_side=128)
    for gray_fn, jgray_fn in ((None, None),
                              (tpre.to_gray_minchannel,
                               jpre.to_gray_minchannel)):
        j_orig, t_orig = {}, {}
        want = jpre.decode_chunk_to_gray(
            images, range(5), jcfg, gray_fn=jgray_fn, color_frac=0.005,
            originals_out=j_orig)
        got = tpre.decode_chunk_to_gray(
            images, range(5), cfg, gray_fn=gray_fn, color_frac=0.005,
            originals_out=t_orig)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        assert got[4] == want[4] and got[4][2] and not got[3][4]
        assert sorted(t_orig) == sorted(j_orig) == [0]
        np.testing.assert_array_equal(t_orig[0], j_orig[0])


def test_small_host_and_device_helpers_match():
    rng = np.random.RandomState(6)
    rgb = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tpre.to_gray_minchannel(rgb),
                                  jpre.to_gray_minchannel(rgb))
    strips = [rng.randint(0, 256, (32, w)).astype(np.uint8)
              for w in (17, 64, 200, 150)]
    cfg, jcfg = OcrConfig(), JaxConfig()
    for bw in (None, 128):
        want = jpre.pad_strips_to_bucket(strips, jcfg, bw)
        got = tpre.pad_strips_to_bucket(strips, cfg, bw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    batch = rng.randint(0, 256, (3, 32, 64)).astype(np.uint8)
    want = np.asarray(jpre.rec_normalize(jnp.asarray(batch), 0.5, 0.5))
    got = tpre.rec_normalize(torch.from_numpy(batch), 0.5, 0.5)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.fixture(scope="module")
def engines():
    cfg = asset_config(compute_dtype="float32")
    return (JaxEngine.from_pretrained(
        config=JaxConfig(**jax_fields(cfg))),
        OcrEngine.from_pretrained(config=cfg, device="cpu"))


def _strips(engine):
    out = []
    for k, s in enumerate(STRIP_SEEDS):
        rng = np.random.RandomState(s)
        text = synth.random_text(rng, engine.charset, 4, 14)
        # the goldens render at the rec height; other heights make
        # rec_resize scale up and down
        height = (32, 32, 48, 24, 64, 20, 32, 40)[k]
        out.append(synth.render_line(text, height))
    return out


def test_recognize_strips_matches_ocrjax(engines):
    jax_engine, port = engines
    strips = _strips(jax_engine)
    want = jax_engine.recognize_strips(strips)
    got = port.recognize_strips(strips)
    assert [r.text for r in got] == [r.text for r in want]
    assert all(len(r.text) >= 4 for r in got)
    np.testing.assert_allclose([r.confidence for r in got],
                               [r.confidence for r in want], atol=1e-5)
    assert not any(r.flipped for r in got)
    assert port.recognize_strips([]) == []


def test_recognize_strips_beyond_the_largest_count_bucket(engines):
    """More strips than the largest count bucket run as one unpadded
    batch, as in the reference."""
    jax_engine, _ = engines
    cfg = asset_config(compute_dtype="float32", line_batch_buckets=(2, 4))
    small_j = JaxEngine.from_pretrained(
        config=JaxConfig(**jax_fields(cfg)))
    small_t = OcrEngine.from_pretrained(config=cfg, device="cpu")
    strips = _strips(jax_engine)[:5]
    assert [r.text for r in small_t.recognize_strips(strips)] == \
        [r.text for r in small_j.recognize_strips(strips)]


def test_recognize_reads_the_golden_strips(engines):
    import json
    jax_engine, port = engines
    with open(os.path.join(ROOT, "assets", "goldens", "goldens.json")) as f:
        golden = {g["seed"]: g for g in json.load(f)["strips"]}
    for s in STRIP_SEEDS[:4]:
        rng = np.random.RandomState(s)
        text = synth.random_text(rng, port.charset, 4, 14)
        strip = synth.render_line(text, port.config.rec_height)
        got = port.recognize(strip)
        assert got.text == jax_engine.recognize(strip).text
        assert golden[s]["gt"] == text
    # a light-on-dark strip is canonicalized first
    inv = np.asarray(255 - strip, np.uint8)
    assert port.recognize(inv).text == got.text


def test_beam_and_flip_stay_refused(engines):
    """Nothing stays refused: beam CTC and rec_try_flip answer as the
    reference does, det_int8 constructs, and rec_dewarp_curl recognizes
    the strips as ocrjax with the flag does."""
    jax_engine, port = engines
    strips = _strips(jax_engine)[:3]
    got = port.recognize_strips(strips, beam=True)
    want = jax_engine.recognize_strips(strips, beam=True)
    assert [r.text for r in got] == [r.text for r in want]
    np.testing.assert_allclose([r.confidence for r in got],
                               [r.confidence for r in want], atol=1e-5)
    assert port.recognize(strips[0], beam=True).text == got[0].text
    OcrEngine(config=port.config.replace(rec_try_flip=True), device="cpu")
    assert OcrEngine(config=port.config.replace(det_int8=True),
                     device="cpu").config.det_int8
    cfg = port.config.replace(rec_dewarp_curl=True)
    got = OcrEngine.from_pretrained(config=cfg, device="cpu"
                                    ).recognize_strips(strips)
    want = JaxEngine.from_pretrained(config=JaxConfig(
        **jax_fields(cfg))).recognize_strips(strips)
    assert [r.text for r in got] == [r.text for r in want]
    np.testing.assert_allclose([r.confidence for r in got],
                               [r.confidence for r in want], atol=1e-5)
