"""attack.backward_stream_ms: the device-stream time between the edges of
the program's `attack.backward` span (CUDA events; idle time included),
per inner step of the first outer step the program recorded."""

from vlabench.common.spans import per_inner_step


def read(rec):
    return per_inner_step(lambda step: step.stream_ms("attack.backward"))
