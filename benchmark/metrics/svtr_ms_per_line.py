"""Device ms (CUDA events) of stages svtr and ctc over the lines the traced
window returned; None where the svtr stage never opened."""
from benchmark.metrics._stage import device_ms


def read(rec):
    if device_ms(rec, "svtr") is None or not rec["lines"]:
        return None
    return device_ms(rec, "svtr", "ctc") / rec["lines"]
