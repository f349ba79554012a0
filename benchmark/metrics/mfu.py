"""The whole step's share of the bf16 peak: FLOPs of the pages completed
(counted on the reference's models at the work the inputs need) over the
traced window's time, %."""
from benchmark.lib.stats import H100_BF16_PEAK_FLOPS


def read(rec):
    return 100.0 * rec["flops"] / rec["window_s"] / H100_BF16_PEAK_FLOPS
