"""Device ms (CUDA events) of stages crnn and ctc over the lines the
traced window returned."""
from benchmark.metrics._stage import device_ms


def read(rec):
    v = device_ms(rec, "crnn", "ctc")
    return None if v is None or not rec["lines"] else v / rec["lines"]
