"""SVTR's share of the bf16 peak over the traffic's words: the FLOPs that
the mix's word boxes (its line file; a4_batch3: 1,232 a call) need at their
own widths (reference/rec_svtr.py's part "svtr": the model's work, local
attention over its window only, whatever the program computes) over the
device ms of stage svtr, %; None where either is missing. The numerator is
the words' work, fixed by the traffic: not the lines the detector returns
(some of them merged words) nor the bucket widths the program pads them to,
so a change to either moves the time alone."""
from benchmark.lib.stats import H100_BF16_PEAK_FLOPS
from benchmark.metrics._stage import device_ms


def read(rec):
    v = device_ms(rec, "svtr")
    flops = (rec.get("work") or {}).get("svtr_flops")
    if not v or not flops:
        return None
    return 100.0 * flops / H100_BF16_PEAK_FLOPS / (v / 1e3)
