"""attack.norm_kernel_share: the share of the program's normalisations
(`norm.calls`, one a LayerNorm or RMSNorm of a block or a final norm, in the
towers and the decoder, forward and recomputation) that launched the
hand-written forward kernel (`norm.kernel`, one a launch), in %, in the first
outer step the program recorded. None where the program keeps no such
counter."""

from vlabench.common.spans import first_step


def read(rec):
    step = first_step()
    if step is None:
        return None
    c = step.counters
    if "norm.kernel" not in c or not c.get("norm.calls"):
        return None
    return 100.0 * c["norm.kernel"] / c["norm.calls"]
