"""attack.device_ms_per_inner_step: the device's busy time (the union of
its intervals) in the profiled outer step, over its inner steps. The work
the card does for an inner step, which the host's speed does not move: a
steadier reading than the rate where the step is host-bound."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    return tr.busy_s / rec["inner_loop"] * 1e3
