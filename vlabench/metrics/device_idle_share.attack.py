"""device_idle_share.attack: the share of the traced outer step in which no
operation ran on the card (1 - union of the device intervals / the traced
stretch's length)."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
