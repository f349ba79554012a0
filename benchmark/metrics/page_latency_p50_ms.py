"""Median wall time of every call in the window, call to returned result,
ms."""
from benchmark.lib.stats import percentile


def read(rec):
    return percentile(rec["latencies_ms"], 50)
