"""K1's share of its roofline: the bytes the window's labelling grids need
(bitmap read once, int32 labels written once; grid shapes from the
config) at the HBM peak, over the device ms of stage ccl, %."""
from benchmark.lib.stats import H100_HBM_BYTES_PER_S
from benchmark.metrics._stage import device_ms


def read(rec):
    v = device_ms(rec, "ccl")
    if not v:
        return None
    return 100.0 * rec["ccl_bytes"] / H100_HBM_BYTES_PER_S / (v / 1e3)
