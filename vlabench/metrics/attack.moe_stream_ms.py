"""attack.moe_stream_ms: the device-stream time of every `moe` span of the
program (one a sparse-expert layer's MLP: router, routing, the grouped
expert products and the shared experts, in the forward and in the
recomputation), summed, per inner step of the first outer step the program
recorded. None for a program without the span."""

from vlabench.common.spans import per_inner_step


def read(rec):
    return per_inner_step(lambda step: step.stream_ms("moe"))
