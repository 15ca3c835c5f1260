"""attack.attention_kernel_share: the share of the program's attention calls
(`attention.calls`, one a block's attention, in the towers and the decoder,
forward and recomputation) that launched the hand-written forward kernel B1
(`attention.kernel`, one a launch), in %, in the first outer step the
program recorded. None where the program keeps no such counter."""

from vlabench.common.spans import first_step


def read(rec):
    step = first_step()
    if step is None:
        return None
    c = step.counters
    if "attention.kernel" not in c or not c.get("attention.calls"):
        return None
    return 100.0 * c["attention.kernel"] / c["attention.calls"]
