"""Host ms of stages load_image and assemble (the page's load and
polarity test, and the result assembly after the fetch) a call; None
where neither opened."""
from benchmark.metrics._stage import host_ms


def read(rec):
    got = [v for v in (host_ms(rec, "load_image"), host_ms(rec, "assemble"))
           if v is not None]
    return sum(got) / rec["calls"] if got else None
