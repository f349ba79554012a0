"""ocrjax_torch.bench_main's watchdog (as tests/test_bench_watchdog.py holds
bench.py's): partial windows record the best window; a run that never
completes a window records an error and exits 3; a finished run exits
quietly; no record compares with a TPU target (vs_baseline); the link
probe that run_bench feeds into the partial metrics rides along, as in
bench.py's record."""

import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=60)


def test_watchdog_partial_windows_records_best(tmp_path):
    p = _run(f"""
        import threading, time
        from ocrjax_torch import bench_main as b
        b.DETAIL = {str(tmp_path / "none.json")!r}
        b._progress["windows"] = [31.2, 44.8]
        b._progress["partial"] = {{
            "crops_per_sec": 6100.0,
            "link_probe": {{"rtt_ms": 0.1, "upload_mb_s": None}}}}
        threading.Thread(target=b._watchdog, args=(3.0,),
                         daemon=True).start()
        time.sleep(30)  # a hung run: the watchdog must exit first
    """)
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert p.returncode == 0
    assert rec["value"] == 44.8
    assert rec["windows"] == [31.2, 44.8]
    assert rec["crops_per_sec"] == 6100.0
    assert "error" in rec
    assert "vs_baseline" not in rec
    assert rec["link_probe"] == {"rtt_ms": 0.1, "upload_mb_s": None}
    assert "prior_hardware_run" not in rec


def test_watchdog_dead_start_records_error(tmp_path):
    detail = tmp_path / "BENCH_DETAIL_TORCH.json"
    detail.write_text(json.dumps({
        "device": "NVIDIA H100 80GB HBM3", "pages_per_sec": 80.0,
        "pages_per_sec_median": 70.0, "pages_per_sec_device": 340.0,
        "crops_per_sec": 15000.0}))
    p = _run(f"""
        import threading, time
        from ocrjax_torch import bench_main as b
        b.DETAIL = {str(detail)!r}
        threading.Thread(target=b._watchdog, args=(3.0,),
                         daemon=True).start()
        time.sleep(30)
    """)
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert p.returncode == 3
    assert rec["value"] == 0.0
    assert "did not complete" in rec["error"]
    assert "vs_baseline" not in rec
    # the last completed run of the port rides along as context only
    prior = rec["prior_hardware_run"]
    assert prior["pages_per_sec"] == 80.0
    assert prior["device"] == "NVIDIA H100 80GB HBM3"


def test_watchdog_exits_quietly_when_done():
    p = _run("""
        import threading
        from ocrjax_torch import bench_main as b
        b._progress["done"] = True
        t = threading.Thread(target=b._watchdog, args=(3.0,), daemon=True)
        t.start(); t.join(timeout=30)
        assert not t.is_alive()
        print("clean")
    """)
    assert p.returncode == 0
    assert p.stdout.strip().splitlines()[-1] == "clean"


def test_prior_run_reads_only_the_ports_detail_file():
    from ocrjax_torch import bench_main as b
    assert b.DETAIL == os.path.join(REPO, "BENCH_DETAIL_TORCH.json")
    src = open(os.path.join(REPO, "ocrjax_torch", "bench_main.py")).read()
    assert "bench_runs" not in src and "vs_baseline" not in src
