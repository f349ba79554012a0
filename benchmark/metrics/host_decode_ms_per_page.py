"""Host ms of stage host_decode (the wait for the lookahead decode and
pack of the next chunk) over the pages of the traced window."""
from benchmark.metrics._stage import host_ms


def read(rec):
    v = host_ms(rec, "host_decode")
    return None if v is None else v / rec["pages"]
