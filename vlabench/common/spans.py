"""What the program's own spans and counters recorded (its recorder,
`roboticattack_torch.utils.profiling`), for the per-layer readers.

The recorder fills while a profiler records: in a traced run, the two
outer steps profiled after the window. The readers read the first of
them, per inner step. A program without the recorder, or a run that
recorded nothing, gives None.
"""

from __future__ import annotations

from typing import Callable, Optional


def first_step():
    """The first outer step the program's recorder holds, or None."""
    try:
        from roboticattack_torch.utils.profiling import recorded_steps
    except ImportError:  # a program from before the recorder
        return None
    steps = recorded_steps()
    return steps[0] if steps else None


def per_inner_step(value: Callable) -> Optional[float]:
    """`value(step)` of the first recorded outer step over its inner steps
    (its `attack.inner` spans); None where either is missing."""
    step = first_step()
    if step is None:
        return None
    inner = len(step.named("attack.inner"))
    v = value(step) if inner else None
    return None if v is None else v / inner
