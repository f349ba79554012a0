"""The benchmark's harness on the CPU, on a small copy of it
(tests/small.py): discovery by name, the result's keys, the reference
against the port, the faults and the control, the import rules."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import small  # noqa: E402

BENCH = small.BENCH
JAX_NAMES = {"jax", "jaxlib", "flax", "optax", "ocrjax"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small.make_root(str(tmp_path_factory.mktemp("bench")))


def _set_limits(root, cell, limits):
    path = os.path.join(root, "benchmark", "limits", f"{cell}.json")
    json.dump({"limits": limits}, open(path, "w"))


# float32 on both sides: the port and the reference agree to rounding
EXACT = {"lines_off": 0.0, "corner_px_mean": 1e-4, "score_gap_max": 1e-5,
         "order_pages": 0.0}


@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_reference_equals_port_in_float32(root, cell):
    _set_limits(root, cell, EXACT)
    out = small.run(root, cell)
    assert out["correct"], out["checks"]
    assert out["unlimited"]["ref_lines"] >= 2
    assert out["unlimited"]["prog_lines"] == out["unlimited"]["ref_lines"]
    assert list(out)[:5] == RESULT_KEYS and list(out)[-1] == "checks"
    assert out["metrics"]["setup_s"]["value"] > 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_run_reports_per_layer_metrics(root):
    _set_limits(root, "small-batch", EXACT)
    out = small.run(root, "small-batch", trace=1)
    assert out["correct"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    m = out["metrics"]
    assert m["mfu"]["unit"] == "%" and m["mfu"]["value"] > 0
    assert "fetch_mb_per_page" in m and "host_decode_ms_per_page" in m
    # a device-timed stage is "not measured" on the CPU: left out
    assert "det_forward_ms_per_page" not in m
    assert "pages_per_s" not in m


def test_new_config_mix_and_metric_are_found_by_name(root, tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries run with no edit to a file that is there."""
    import shutil
    new = str(tmp_path / "root")
    shutil.copytree(root, new, symlinks=True)
    b = os.path.join(new, "benchmark")
    conf = json.load(open(os.path.join(b, "configs",
                                       "small_page960.json")))
    conf["ocr_config"]["det_max_side"] = 512
    json.dump(conf, open(os.path.join(b, "configs", "tiny512.json"), "w"))
    mix = json.load(open(os.path.join(b, "traffic", "small-batch.json")))
    mix.update(draw="shuffle", call_pages=[1, 2, 2], calls=2)
    json.dump(mix, open(os.path.join(b, "traffic", "repeat3.json"), "w"))
    with open(os.path.join(b, "metrics", "lines_per_page.py"), "w") as f:
        f.write('def read(rec):\n    return rec["lines"] / rec["pages"]\n')
    _set_limits(new, "tiny-repeat", {"lines_off": 1.0})
    bench = json.load(open(os.path.join(new, "BENCHMARK.json")))
    bench["configs"].append(dict(name="tiny512", source="test",
                                 file="benchmark/configs/tiny512.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="tiny-repeat", config="tiny512",
                                   traffic="repeat3", chips=1, why="test"))
    bench["per_layer"].append(dict(
        name="lines_per_page", unit="lines/page", better="higher",
        source="program_counter", layer="whole step", moves="pages_per_s",
        workloads=["tiny-repeat"]))
    json.dump(bench, open(os.path.join(new, "BENCHMARK.json"), "w"))
    out = small.run(new, "tiny-repeat", trace=1)
    assert out["metrics"]["lines_per_page"]["value"] >= 0
    assert out["unlimited"]["pages"] in (3, 6)   # one or two distinct


def test_a_mix_may_name_a_generator_module(root, tmp_path):
    """A mix whose traffic its parameters cannot state names a module of
    its own in traffic/: its functions replace the general generator's
    (here the call sequence, the entry's call and the reference's pass),
    again with no edit to a file that is there."""
    import shutil
    new = str(tmp_path / "root")
    shutil.copytree(root, new, symlinks=True)
    b = os.path.join(new, "benchmark")
    mix = json.load(open(os.path.join(b, "traffic", "small-batch.json")))
    mix["generator"] = "odd_pages"
    json.dump(mix, open(os.path.join(b, "traffic", "odd.json"), "w"))
    with open(os.path.join(b, "traffic", "odd_pages.py"), "w") as f:
        f.write(
            "def call_sequence(mix, n_pages, seed):\n"
            "    return [(1, 3)]\n\n"
            "def make_call(engine, mix, pages):\n"
            "    return lambda call: [engine.ocr(pages[i])\n"
            "                         for i in call]\n\n"
            "def reference_pages(ref, mix, pages, todo, out):\n"
            "    for i in todo:\n"
            "        out[i] = ref.run('fused', [pages[i]])[0]\n"
            "    return out\n")
    _set_limits(new, "small-odd", EXACT)
    bench = json.load(open(os.path.join(new, "BENCHMARK.json")))
    bench["workloads"].append(dict(name="small-odd",
                                   config="small_page960", traffic="odd",
                                   chips=1, why="test"))
    json.dump(bench, open(os.path.join(new, "BENCHMARK.json"), "w"))
    out = small.run(new, "small-odd")
    assert out["correct"], out["checks"]
    assert out["unlimited"]["pages"] == 2


@pytest.mark.parametrize("fault", ["half_pages", "altered_token"])
@pytest.mark.parametrize("cell", ["small-batch", "small-single",
                                  "small-tiled"])
def test_a_fault_under_the_timed_path_is_not_correct(root, cell, fault):
    _set_limits(root, cell, {"lines_off": 0.25, "corner_px_mean": 1.0,
                             "score_gap_max": 0.05})
    assert small.run(root, cell)["correct"]
    out = small.run(root, cell, fault=fault)
    assert not out["correct"], out["checks"]


def test_control_is_not_correct(root):
    """The control (the reference in float8 in the program's place) fails
    the tiled cell's limits at the small size."""
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {root!r}); sys.path.insert(1, {small.REPO!r})\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import readings\n"
        "for r in readings.readings('small-tiled', 'fp8', [1], "
        "device='cpu'):\n"
        "    print(json.dumps(r))\n")
    real = json.load(open(os.path.join(BENCH, "limits", "a4-batch3.json")))
    _set_limits(root, "small-tiled", real["limits"])
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert not r["correct"], r["numbers"]


def test_no_cuda_exits_without_a_result():
    res = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                          "--workload", "page960-single", "--seed",
                          str(2 ** 31 + 5), "--seconds", "1", "--trace",
                          "0"], capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_a_loaded_jax_module_refuses_the_run(root):
    """A run whose process holds a module named jax (or the JAX package)
    after the window exits with no result."""
    _set_limits(root, "small-single", EXACT)
    extra = ("import types; sys.modules['ocrjax'] = "
             "types.ModuleType('ocrjax')")
    with pytest.raises(RuntimeError, match=r"\(4\)"):
        small.run(root, "small-single", extra=extra)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(*sub):
    top = os.path.join(BENCH, *sub)
    for d, _, files in os.walk(top):
        if "tests" in os.path.relpath(d, BENCH).split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_the_benchmark_runs_imports_jax():
    for path in _sources():
        bad = set(_imports(path)) & JAX_NAMES
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        bad = set(_imports(path)) & (JAX_NAMES | {"ocrjax_torch"})
        assert not bad, (path, bad)


def test_lstm_flops_as_the_formula_counts_them():
    import torch

    from benchmark.lib import stats
    from benchmark.reference import models as M
    flat, _ = M.read_safetensors(os.path.join(small.REPO, "assets",
                                              "rec.safetensors"))
    p = M.Params(flat, torch.device("meta"))
    x = torch.empty(3, 40, 256, device="meta")
    lens = torch.full((3,), 40, device="meta")
    got = stats.counted_flops(
        lambda: (M._bilstm(p, "BiLSTM_0", x, lens),
                 M._bilstm(p, "BiLSTM_1", torch.empty(
                     3, 40, 320, device="meta"), lens)))
    assert got == stats.crnn_bilstm_flops(160, 256, 3, 160)


def test_call_sequences_are_fixed_by_the_seed():
    from benchmark.lib import traffic
    for mix_name in ("batch32", "single", "a4_batch3"):
        mix = traffic.load_mix(mix_name)
        n = 96 if mix["source"]["file"] == "bench_traffic.npz" else 2
        a = traffic.call_sequence(mix, n, 2 ** 31 + 11)
        assert a == traffic.call_sequence(mix, n, 2 ** 31 + 11)
        assert a != traffic.call_sequence(mix, n, 12)
        used = sorted(i for call in a for i in call)
        if mix["draw"] == "permutation":
            assert used == list(range(n))   # every seed, the same pages


# a recognizer that is not the CRNN, added as one new file
PROBE = '''"""A test recognizer: one stride-(4, 4) convolution over the
strip's height to W / 4 frames, then a dense head."""

import numpy as np
import torch

from . import models as M


def logits(p, cfg, strips, widths):
    x = M.conv(p, "Conv_0", strips[:, None], 4, ((0, 0), (0, 0)))
    feats = x[:, :, 0].permute(0, 2, 1)
    kernel = p["params/Dense_0/kernel"]
    if p.lowp:
        feats, kernel = M.round_bf16(feats), M.round_bf16(kernel)
    lengths = torch.clamp(-(-widths.long() // 4), 0, feats.shape[1])
    return M._mm(feats, kernel) + p["params/Dense_0/bias"], lengths


def _conv(cfg, w):
    return 2.0 * w * cfg.probe_channels * cfg.rec_height


def flops(p, cfg, widths):
    w = np.asarray(widths, np.float64)
    classes = p["params/Dense_0/kernel"].shape[1]
    return _conv(cfg, w) + 2.0 * w / 4 * cfg.probe_channels * classes


def parts(cfg, widths):
    w = np.asarray(widths, np.float64)
    return {"rec_probe_conv": (_conv(cfg, w), 4.0 * cfg.rec_height * w
                               + w * cfg.probe_channels)}


def init(cfg, num_classes):
    c = cfg.probe_channels
    return [("params/Conv_0/kernel", (cfg.rec_height, 4, 1, c), "normal"),
            ("params/Conv_0/bias", (c,), "zeros"),
            ("params/Dense_0/kernel", (c, num_classes), ("normal", 0.5)),
            ("params/Dense_0/bias", (num_classes,), "zeros")]
'''

# the program's place taken by the float32 reference, for a recognizer
# that the program does not have
REFERENCE_ENGINE = """
from types import SimpleNamespace as NS
from benchmark.reference.pipeline import Reference


def reference_engine(cfg, assets, device):
    ref = Reference(cfg, assets, device)

    def ocr_batch(pages, **kw):
        return [NS(lines=[NS(box=NS(quad=q, score=s), text=t, confidence=c)
                          for q, s, t, c in zip(d["quads"], d["scores"],
                                                d["texts"], d["confs"])])
                for d in ref.run("pooled", pages)]
    return NS(ocr_batch=ocr_batch)


R.build_engine = reference_engine
"""


def _child(root, code):
    """Runs code with the copy at root first on the path -> its last
    line of output, as JSON."""
    head = (f"import sys, json, torch\nsys.path.insert(0, {root!r})\n"
            f"sys.path.insert(1, {small.REPO!r})\ntorch.set_num_threads(2)\n")
    res = subprocess.run([sys.executable, "-c", head + code], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_a_new_recognizer_is_found_by_name(root, tmp_path):
    """A recognizer added as reference/rec_probe.py, a configuration that
    names it with a seeded asset, and a metric that reads its part run
    through the reference, the work count, the record and the seeded
    assets with no edit to a file that is there."""
    import shutil
    new = str(tmp_path / "root")
    shutil.copytree(root, new, symlinks=True)
    b = os.path.join(new, "benchmark")
    with open(os.path.join(b, "reference", "rec_probe.py"), "w") as f:
        f.write(PROBE)
    with open(os.path.join(b, "metrics", "probe_conv_share.py"), "w") as f:
        f.write('def read(rec):\n'
                '    return 100.0 * rec["work"]["rec_probe_conv_flops"] '
                '/ rec["flops"]\n')
    conf = json.load(open(os.path.join(b, "configs",
                                       "small_page960.json")))
    conf["ocr_config"].update(rec_arch="probe", probe_channels=16)
    entry = {"seed": 2 ** 31 + 3}
    pin = _child(new, (
        "import hashlib\nfrom types import SimpleNamespace\n"
        "from benchmark.lib import seeded\n"
        "from benchmark.reference import rec_probe\n"
        "cfg = SimpleNamespace(rec_height=32, probe_channels=16)\n"
        f"blob = seeded.encode(seeded.draw(rec_probe.init(cfg, 96), "
        f"{entry['seed']}), {{'seed': '{entry['seed']}', "
        "'rec_arch': 'probe'})\n"
        "print(json.dumps(hashlib.sha256(blob).hexdigest()))\n"))
    bench = json.load(open(os.path.join(new, "BENCHMARK.json")))
    bench["configs"].append(dict(name="small_probe", source="test",
                                 file="benchmark/configs/small_probe.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="small-probe", config="small_probe",
                                   traffic="small-batch", chips=1,
                                   why="test"))
    bench["per_layer"].append(dict(
        name="probe_conv_share", unit="%", better="higher",
        source="program_counter", layer="kernels: probe", moves="pages_per_s",
        workloads=["small-probe"]))
    json.dump(bench, open(os.path.join(new, "BENCHMARK.json"), "w"))
    _set_limits(new, "small-probe", EXACT)
    path = os.path.join(b, "configs", "small_probe.json")

    # a pin that the drawn weights do not have stops the run before set-up
    json.dump(dict(conf, assets=dict(conf["assets"], rec=dict(
        entry, sha256="0" * 64))), open(path, "w"))
    with pytest.raises(RuntimeError, match="the configuration pins 0{64}"):
        small.run(new, "small-probe", extra=REFERENCE_ENGINE)
    cache = os.path.join(new, ".bench_cache", "assets")
    assert not os.path.exists(cache) or not os.listdir(cache)

    json.dump(dict(conf, assets=dict(conf["assets"], rec=dict(
        entry, sha256=pin))), open(path, "w"))
    out = small.run(new, "small-probe", trace=1, extra=REFERENCE_ENGINE)
    assert out["correct"], out["checks"]
    assert out["unlimited"]["ref_lines"] >= 2
    assert 0 < out["metrics"]["probe_conv_share"]["value"] < 100
    assert os.listdir(cache) == [f"{pin}.safetensors"]

    # Work a call: the detector's count plus the probe's flops over the
    # call's strips; its part summed the same way
    got = _child(new, (
        "from types import SimpleNamespace\n"
        "import numpy as np\n"
        "from benchmark import run as R\n"
        "from benchmark.lib import stats, traffic\n"
        "from benchmark.lib.work import Work\n"
        "from benchmark.reference import models as M, pipeline as P, "
        "rec_probe\n"
        "conf = R.load_json(R.ROOT, 'benchmark/configs/small_probe.json')\n"
        "cfg = SimpleNamespace(**conf['ocr_config'])\n"
        "assets = R.asset_paths(conf, R.ROOT)\n"
        "mix = traffic.load_mix('small-batch')\n"
        "pages = traffic.load_pages(mix)\n"
        "work = Work(cfg, assets, mix, pages)\n"
        "det = M.Params(M.read_safetensors(assets['det'])[0], 'cpu')\n"
        "rec = M.Params(M.read_safetensors(assets['rec'])[0], 'cpu')\n"
        "arch = dict(P.FLAGSHIP_ARCH, head_stride=1)\n"
        "with torch.inference_mode():\n"
        "    det_f = stats.counted_flops(M.db_prob, det, arch, "
        "torch.zeros(1, 3, 64, 64)) / 64.0 ** 2 * cfg.det_max_side ** 2\n"
        "lines = traffic.page_lines(mix)\n"
        "rows = []\n"
        "for call in traffic.call_sequence(mix, len(pages), 5):\n"
        "    w = np.concatenate([stats.strip_widths(lines[i], 32) "
        "for i in call])\n"
        "    rows.append([work.call_flops(call), len(call) * det_f + "
        "float(rec_probe.flops(rec, cfg, w).sum()), "
        "work.window_parts([call]), "
        "float(rec_probe.parts(cfg, w)['rec_probe_conv'][0].sum()), "
        "float(rec_probe.parts(cfg, w)['rec_probe_conv'][1].sum())])\n"
        "print(json.dumps(rows))\n"))
    assert got
    for flops, want, parts, conv_f, conv_b in got:
        assert flops == pytest.approx(want, rel=1e-12)
        assert parts == {"rec_probe_conv_flops": pytest.approx(conv_f),
                         "rec_probe_conv_bytes": pytest.approx(conv_b)}


def _recognizer_modules():
    top = os.path.join(BENCH, "reference")
    return sorted(f[:-3] for f in os.listdir(top)
                  if f.startswith("rec_") and f.endswith(".py"))


@pytest.mark.parametrize("name", _recognizer_modules())
def test_a_recognizer_counts_the_flops_of_its_own_logits(name):
    """flops(p, cfg, widths) of every reference/rec_*.py equals what
    models.counting reads from the module's own logits, strip by strip,
    on weights of a configuration that names it."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from benchmark.lib import seeded, stats
    from benchmark.reference import models as M
    from benchmark.reference import recognizers
    mod = recognizers.load(name)
    confs = [json.load(open(os.path.join(BENCH, "configs", f)))
             for f in sorted(os.listdir(os.path.join(BENCH, "configs")))]
    conf = next(c for c in confs
                if "rec_" + recognizers.arch(c["ocr_config"]) == name)
    cfg = SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in conf["ocr_config"].items()})
    a = conf["assets"]["rec"]
    if "path" in a:
        flat = M.read_safetensors(os.path.join(small.REPO, a["path"]))[0]
    else:
        classes = len(M.load_charset(os.path.join(
            small.REPO, conf["assets"]["charset"]["path"]))) + 1
        flat = dict(seeded.draw(mod.init(cfg, classes), a["seed"]))
    p = M.Params(flat, torch.device("cpu"))
    widths = np.array([64, 200])
    want = []
    with torch.inference_mode():
        for w in widths:
            want.append(stats.counted_flops(
                mod.logits, p, cfg, torch.zeros(1, cfg.rec_height, int(w)),
                torch.full((1,), int(w))))
    assert list(mod.flops(p, cfg, widths)) == want


# lib/work.py's count before the recognizer was named: the CRNN's FLOPs a
# strip column at width 128, times each page's strip widths
OLD_WORK = """
import json
import numpy as np
import torch
from benchmark.lib import stats, traffic
from benchmark.reference import models as M
from benchmark.reference import pipeline as P


class OldWork:
    def __init__(self, cfg, assets, mix, pages):
        cpu = torch.device("cpu")
        rec = M.Params(M.read_safetensors(assets["rec"])[0], cpu)
        H = cfg.rec_height
        with torch.inference_mode():
            self.rec_per_px = stats.counted_flops(
                M.crnn_logits, rec, torch.zeros(1, H, 128),
                torch.full((1,), 128)) / 128.0
        tiled = mix["lane"] == "tiled"
        if tiled:
            flat, m = M.read_safetensors(assets["det_tile"])
            arch, S = json.loads(m["arch"]), cfg.tile_size
        else:
            flat = M.read_safetensors(assets["det"])[0]
            arch = dict(P.FLAGSHIP_ARCH, head_stride=cfg.det_head_stride)
            S = cfg.det_max_side
        with torch.inference_mode():
            det_px = stats.counted_flops(
                M.db_prob, M.Params(flat, cpu), arch,
                torch.zeros(1, 3, 64, 64)) / 64.0 ** 2
        det_s = det_px * S * S
        lines = traffic.page_lines(mix)
        self.page_flops = []
        for page, q in zip(pages, lines):
            w = stats.strip_widths(q, H)
            det_f = (det_px * page.shape[0] * page.shape[1] if tiled
                     else det_s)
            self.page_flops.append(det_f + self.rec_per_px * float(w.sum()))

    def call_flops(self, call):
        return float(sum(self.page_flops[i] for i in call))
"""


def test_the_crnn_behind_the_interface_counts_and_reads_as_before(root):
    """On the small copy: Work's FLOPs of every call equal the count of
    before bit for bit, and the reference's pages in float32 equal those
    of a reference that calls models.crnn_logits itself."""
    got = _child(root, OLD_WORK + (
        "from types import SimpleNamespace\n"
        "from benchmark import run as R\n"
        "from benchmark.lib import check\n"
        "from benchmark.lib.work import Work\n"
        "bench = R.load_json(R.ROOT, 'BENCHMARK.json')\n"
        "out = {}\n"
        "for cell in bench['workloads']:\n"
        "    entry = next(c for c in bench['configs']\n"
        "                 if c['name'] == cell['config'])\n"
        "    conf = R.load_json(R.ROOT, entry['file'])\n"
        "    cfg = SimpleNamespace(**{k: tuple(v) if isinstance(v, list) "
        "else v for k, v in conf['ocr_config'].items()})\n"
        "    assets = R.asset_paths(conf, R.ROOT)\n"
        "    mix = traffic.load_mix(cell['traffic'])\n"
        "    pages = traffic.load_pages(mix)\n"
        "    work, old = (Work(cfg, assets, mix, pages),\n"
        "                 OldWork(cfg, assets, mix, pages))\n"
        "    calls = traffic.call_sequence(mix, len(pages), 2 ** 31 + 9)\n"
        "    same = [work.call_flops(c) == old.call_flops(c) for c in calls]\n"
        "    ref = P.Reference(conf['ocr_config'], assets, 'cpu')\n"
        "    todo = sorted({i for c in calls for i in c})\n"
        "    a = traffic.reference_pages(ref, mix, pages, todo, {})\n"
        "    ref.recognizer = SimpleNamespace(\n"
        "        logits=lambda p, cfg, s, w: M.crnn_logits(p, s, w))\n"
        "    b = traffic.reference_pages(ref, mix, pages, todo, {})\n"
        "    n = check.compare([a[i] for i in todo], [b[i] for i in todo])\n"
        "    out[cell['name']] = [same, [n[k] for k in ('lines_off', "
        "'corner_px_max', 'score_gap_max', 'cer', 'conf_gap_p50')], "
        "n['ref_lines'], "
        "work.window_parts(calls)]\n"
        "print(json.dumps(out))\n"))
    assert set(got) == set(small.CELLS)
    for cell, (same, gaps, ref_lines, parts) in got.items():
        assert same and all(same), cell
        assert gaps == [0.0] * 5 and ref_lines >= 2, (cell, gaps)
        assert parts == {}, cell


def _probe_spec():
    return [("params/Conv_0/kernel", (3, 3, 1, 8), "normal"),
            ("params/Conv_0/bias", (8,), "zeros"),
            ("params/LayerNorm_0/scale", (8,), "ones"),
            ("params/pos", (1, 4, 8), ("normal", 0.02))]


@pytest.fixture
def seeded_init(monkeypatch):
    from types import SimpleNamespace

    from benchmark.lib import seeded
    monkeypatch.setattr(seeded.recognizers, "resolve", lambda cfg:
                        SimpleNamespace(init=lambda cfg, n: _probe_spec()))
    return seeded


def _seeded_asset(seeded, cache, seed, pin, name="rec"):
    return seeded.asset(name, {"seed": seed, "sha256": pin},
                        {"rec_height": 32, "rec_arch": "probe"},
                        os.path.join(small.REPO, "assets",
                                     "rec.charset.txt"), cache)


def _seeded_pin(seeded, seed):
    import hashlib
    return hashlib.sha256(seeded.encode(
        seeded.draw(_probe_spec(), seed),
        {"seed": str(seed), "rec_arch": "probe"})).hexdigest()


def test_a_seeded_asset_is_drawn_from_its_seed(seeded_init, tmp_path):
    """One seed written twice gives one file; two seeds differ; each
    tensor follows its rule and reads back as written, by the reference's
    and the program's readers."""
    import numpy as np

    from benchmark.reference import models as M
    from ocrjax_torch import weights
    seeded = seeded_init
    big = 2 ** 31 + 77
    pin = _seeded_pin(seeded, big)
    paths = [_seeded_asset(seeded, str(tmp_path / k), big, pin)
             for k in ("a", "b")]
    assert paths == [str(tmp_path / k / f"{pin}.safetensors")
                     for k in ("a", "b")]
    assert M.sha256(paths[0]) == M.sha256(paths[1]) == pin
    assert pin != _seeded_pin(seeded, big + 1)
    flat, meta = M.read_safetensors(paths[0])
    assert meta == {"seed": str(big), "rec_arch": "probe"}
    assert list(flat) == [n for n, _, _ in _probe_spec()]
    assert not flat["params/Conv_0/bias"].any()
    assert (flat["params/LayerNorm_0/scale"] == 1).all()
    k = np.random.default_rng([big, 0]).standard_normal((3, 3, 1, 8))
    assert np.array_equal(flat["params/Conv_0/kernel"],
                          (k / 3.0).astype(np.float32))
    assert flat["params/pos"].std() < 0.05
    theirs, _ = weights.read_safetensors(paths[0])
    for name, a in flat.items():
        assert np.array_equal(theirs[name], a)


def test_a_seeded_asset_off_its_pin_is_refused(seeded_init, tmp_path):
    """A pin that the drawn weights do not have is refused with the
    message a changed file gets, and nothing is written; a cached file
    whose bytes were altered is refused, not reused."""
    seeded = seeded_init
    cache = str(tmp_path / "assets")
    with pytest.raises(SystemExit, match=r"asset rec \(rec_probe seed 5, "
                       r".*\) has sha256 [0-9a-f]{64}, the configuration "
                       r"pins 0{64}"):
        _seeded_asset(seeded, cache, 5, "0" * 64)
    assert not os.listdir(tmp_path)
    pin = _seeded_pin(seeded, 5)
    path = _seeded_asset(seeded, cache, 5, pin)
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 1
    open(path, "wb").write(bytes(blob))
    with pytest.raises(SystemExit, match=f"the configuration pins {pin}"):
        _seeded_asset(seeded, cache, 5, pin)
    assert open(path, "rb").read() == bytes(blob)


def test_a_seeded_asset_is_cached_under_its_content(seeded_init, tmp_path):
    """The cache holds each drawn file under its sha256: a new pin draws
    its own file beside an older one and never reads the older; only the
    recognizer's weights may be drawn, under a pin that is a sha256."""
    seeded = seeded_init
    cache = str(tmp_path / "assets")
    old, new = _seeded_pin(seeded, 5), _seeded_pin(seeded, 6)
    a = _seeded_asset(seeded, cache, 5, old)
    b = _seeded_asset(seeded, cache, 6, new)
    assert a != b and sorted(os.listdir(cache)) == sorted(
        [f"{old}.safetensors", f"{new}.safetensors"])
    assert _seeded_asset(seeded, cache, 5, old) == a
    with pytest.raises(SystemExit, match="only the recognizer's weights"):
        _seeded_asset(seeded, cache, 5, old, name="det")
    with pytest.raises(SystemExit, match="not a sha256"):
        _seeded_asset(seeded, cache, 5, "../" + old[3:])


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card(card):
    bench = json.load(open(os.path.join(small.REPO, "BENCHMARK.json")))
    for cell in bench["workloads"]:
        res = subprocess.run(
            [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
             cell["name"], "--seed", "4242", "--seconds", "2", "--trace",
             "0"], capture_output=True, text=True, timeout=900,
            cwd=small.REPO)
        assert res.returncode == 0, res.stderr[-3000:]
        out = json.loads(res.stdout.strip().splitlines()[-1])
        assert out["correct"], out["checks"]
