"""Bytes the program's fetch stages counted (StageTimer.add_bytes), in
MB (10**6), over the pages of the traced window."""


def read(rec):
    b = rec.get("stage_bytes") or {}
    return sum(b.values()) / 1e6 / rec["pages"] if b else None
