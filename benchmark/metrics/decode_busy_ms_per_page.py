"""Host ms of stage decode (the decode threads' work on each page of the
fused and pooled lanes' chunk decode, summed over the threads) over the
pages of the traced window: the busy time beside host_decode's wait."""
from benchmark.metrics._stage import host_ms


def read(rec):
    v = host_ms(rec, "decode")
    return None if v is None else v / rec["pages"]
