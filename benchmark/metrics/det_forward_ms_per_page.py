"""Device ms (CUDA events) of stage det_forward, the detector program's
forward, over the pages of the traced window."""
from benchmark.metrics._stage import device_ms


def read(rec):
    v = device_ms(rec, "det_forward")
    return None if v is None else v / rec["pages"]
