"""Pages of every call completed in the window over the wall time from the
first call's start to the last call's end."""


def read(rec):
    return rec["pages"] / rec["window_s"]
