"""Shared by the stage readers: a stage's total over the traced window, or
None where the stage never opened."""


def device_ms(rec, *names):
    dev = rec.get("device_ms") or {}
    got = [dev[n] for n in names if isinstance(dev.get(n), float)]
    return sum(got) if got else None


def host_ms(rec, name):
    return (rec.get("host_ms") or {}).get(name)
