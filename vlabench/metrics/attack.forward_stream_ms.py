"""attack.forward_stream_ms: the device-stream time between the edges of
the program's `attack.forward` span (CUDA events; idle time between its
kernels included), per inner step of the first outer step the program
recorded. Beside `attack.forward_host_ms` it says whether the host or the
card sets the forward's pace."""

from vlabench.common.spans import per_inner_step


def read(rec):
    return per_inner_step(lambda step: step.stream_ms("attack.forward"))
