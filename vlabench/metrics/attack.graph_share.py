"""attack.graph_share: the share of the inner steps of the first outer step
the program recorded (its `attack.inner` spans) that replayed the attack
step's CUDA graph (the program's counter `attack.graph_replays`, one a
replay), in %. None where the program keeps no such counter."""

from vlabench.common.spans import first_step


def read(rec):
    step = first_step()
    if step is None:
        return None
    inner = len(step.named("attack.inner"))
    replays = step.counters.get("attack.graph_replays")
    if replays is None or not inner:
        return None
    return 100.0 * replays / inner
