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
