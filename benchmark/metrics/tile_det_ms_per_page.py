"""Device ms (CUDA events) of stage tile_det, the tile detector's forward,
over the pages of the traced window."""
from benchmark.metrics._stage import device_ms


def read(rec):
    v = device_ms(rec, "tile_det")
    return None if v is None else v / rec["pages"]
