"""Host ms of stage fused_dispatch (pack, upload and the program's launch)
a call."""
from benchmark.metrics._stage import host_ms


def read(rec):
    v = host_ms(rec, "fused_dispatch")
    return None if v is None else v / rec["calls"]
