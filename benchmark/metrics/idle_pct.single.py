"""Share of the traced window with no operation on the device, %."""


def read(rec):
    if "busy_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["traced_s"])
