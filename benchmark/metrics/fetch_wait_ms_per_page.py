"""Host ms of stage fetch_wait (the host blocked on a device-to-host
copy's event) over the pages of the traced window."""
from benchmark.metrics._stage import host_ms


def read(rec):
    v = host_ms(rec, "fetch_wait")
    return None if v is None else v / rec["pages"]
