"""attack.inner_step_ms_p50: the median outer step's host time (draws, the
step, the next batch staged, the synchronize) over its inner steps, from
the benchmark's own clock around each untraced outer step of the window."""

import statistics


def read(rec):
    if not rec.get("outer_s"):
        return None
    return statistics.median(rec["outer_s"]) / rec["inner_loop"] * 1e3
