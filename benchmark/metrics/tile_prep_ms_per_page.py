"""Host ms of stage tile_prep (the wait for the next page's tile plan,
luma and prescreen) over the pages of the traced window."""
from benchmark.metrics._stage import host_ms


def read(rec):
    v = host_ms(rec, "tile_prep")
    return None if v is None else v / rec["pages"]
