"""Host ms of stage tile_prep_work (the tile-prep thread's load, plan,
luma and prescreen of each page) over the pages of the traced window: the
busy time beside tile_prep's wait."""
from benchmark.metrics._stage import host_ms


def read(rec):
    v = host_ms(rec, "tile_prep_work")
    return None if v is None else v / rec["pages"]
