"""Set-up: process start to the first timed call (imports, CUDA start,
weights, kernel builds, the cell's graph captures), seconds."""


def read(rec):
    return rec["setup_s"]
