"""The readings that the check's limits are set from, at each cell's own
size, many seeds in one process:

    python3 benchmark/readings.py --workload <name> --side <side> \
        --seeds 1 2 3 ...

--side program: the program as the configuration states it. For each
seed every distinct call of its sequence runs twice (a capture, then a
replay) and the replay's results are judged, as a run judges its window.
--side fp8: the control, the reference put in the program's place one
step below the configuration's precision (reference/models.Params).
Each is compared with the float32 reference (lib/check.py). One JSON line
a seed: the numbers, the limits and whether they would pass. It needs a
CUDA device; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import run as R  # noqa: E402
from benchmark.lib import check, traffic  # noqa: E402
from benchmark.reference.pipeline import Reference  # noqa: E402

SIDES = ("program", "fp8")


def readings(workload: str, side: str, seeds, device: str = "cuda",
             root: str = ROOT):
    bench = R.load_json(root, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = R.load_json(root, entry["file"])
    mix = traffic.load_mix(cell["traffic"])
    assets = R.asset_paths(conf, root)
    pages = traffic.load_pages(mix)
    limits = check.load_limits(workload)

    def by_page(ref, idx, cache):
        traffic.reference_pages(ref, mix, pages,
                                sorted(set(idx) - set(cache)), cache)
        return [cache[i] for i in idx]

    seqs = [traffic.call_sequence(mix, len(pages), s) for s in seeds]
    judged = []
    if side == "program":
        engine = R.build_engine(R.ocr_config(conf), assets, device)
        run = traffic.make_call(engine, mix, pages)
        for seq in seqs:
            got, idx = [], []
            for call in dict.fromkeys(seq):
                run(call)
                got += [check.page_dict(r) for r in run(call)]
                idx += list(call)
            judged.append((got, idx))
        del engine, run
        torch.cuda.empty_cache()
    else:
        low = Reference(conf["ocr_config"], assets, device, lowp=side)
        cache = {}
        for seq in seqs:
            idx = [i for call in dict.fromkeys(seq) for i in call]
            judged.append((by_page(low, idx, cache), idx))
        del low
    ref, cache = Reference(conf["ocr_config"], assets, device), {}
    out = []
    for seed, (got, idx) in zip(seeds, judged):
        numbers = check.compare(got, by_page(ref, idx, cache))
        out.append({"workload": workload, "side": side, "seed": seed,
                    "correct": check.judge(numbers, limits),
                    "numbers": numbers, "limits": limits})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=SIDES, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings run on a CUDA device", file=sys.stderr)
        return 3
    for r in readings(args.workload, args.side, args.seeds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
