"""The port's classic DB postprocess on the host
(ocrjax_torch/postprocess/host_boxes.py) against ocrjax's, on the maps of
tests/test_native_boxes.py and a few more: identical boxes and scores;
unclip_polygon and order_quad identical on convex polygons in both
orientations. Importing the module needs no cv2; a call without it raises
ImportError naming cv2."""

import subprocess
import sys

import numpy as np
import pytest

from ocrjax.postprocess import host_boxes as J
from ocrjax_torch.postprocess import host_boxes as T


def _maps():
    rect = np.zeros((128, 128), np.float32)
    rect[30:50, 20:80] = 0.9
    rect[70:94, 16:116] = 0.8
    rot = np.zeros((128, 128), np.float32)
    for i in range(60):
        for t in range(3):
            rot[20 + i, 30 + i + t] = 0.95
    scored = np.zeros((64, 64), np.float32)
    scored[10:20, 10:40] = 0.9
    scored[40:50, 10:40] = 0.45
    rng = np.random.RandomState(4)
    blobs = np.zeros((100, 140), np.float32)
    for _ in range(12):
        y, x = rng.randint(0, 90), rng.randint(0, 120)
        blobs[y:y + rng.randint(3, 10), x:x + rng.randint(5, 20)] = \
            rng.uniform(0.5, 1.0)
    return {"rect": rect, "rotated": rot, "scored": scored, "blobs": blobs,
            "noisy": rng.rand(64, 80).astype(np.float32),
            "empty": np.zeros((32, 32), np.float32)}


@pytest.mark.parametrize("name", list(_maps()))
@pytest.mark.parametrize("kw", [{}, {"box_thresh": 0.6},
                                {"min_box_size": 1, "unclip_ratio": 0.0},
                                {"max_candidates": 2, "box_thresh": 0.3}])
def test_extract_boxes_host_equals_ocrjax(name, kw):
    prob = _maps()[name]
    got = T.extract_boxes_host(prob, **kw)
    want = J.extract_boxes_host(prob, **kw)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if name == "rotated" and kw.get("unclip_ratio") == 0.0:
        b = got[0][0]
        e1, e2 = np.linalg.norm(b[1] - b[0]), np.linalg.norm(b[3] - b[0])
        assert max(e1, e2) > 70 and min(e1, e2) < 10


def test_unclip_and_order_quad_equal_ocrjax():
    rng = np.random.RandomState(9)
    for _ in range(20):
        ang = rng.uniform(0, np.pi)
        c, s = np.cos(ang), np.sin(ang)
        w, h = rng.uniform(5, 80, 2)
        base = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
        quad = (base @ np.array([[c, s], [-s, c]]) + rng.uniform(20, 90, 2)
                ).astype(np.float32)
        for q in (quad, quad[::-1]):                # both orientations
            for ratio in (0.0, 1.5, 2.0):
                np.testing.assert_array_equal(T.unclip_polygon(q, ratio),
                                              J.unclip_polygon(q, ratio))
            np.testing.assert_array_equal(T.order_quad(q), J.order_quad(q))
    hexagon = np.array([[0, 5], [4, 0], [12, 0], [16, 5], [12, 10],
                        [4, 10]], np.float32)
    np.testing.assert_array_equal(T.unclip_polygon(hexagon, 1.5),
                                  J.unclip_polygon(hexagon, 1.5))
    degenerate = np.zeros((4, 2), np.float32)
    np.testing.assert_array_equal(T.unclip_polygon(degenerate, 1.5),
                                  degenerate)


def test_imports_without_cv2_and_names_it_when_called():
    code = ("import sys; sys.modules['cv2'] = None\n"
            "import numpy as np\n"
            "from ocrjax_torch.postprocess import host_boxes\n"
            "try:\n"
            "    host_boxes.extract_boxes_host(np.zeros((4, 4), np.float32))\n"
            "except ImportError as e:\n"
            "    print('cv2' in str(e))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "True"
