"""attack.attention_stream_ms: the device-stream time of every `attention`
span of the program (one a block's attention call, in the towers and the
decoder, forward and recomputation), summed, per inner step of the first
outer step the program recorded."""

from vlabench.common.spans import per_inner_step


def read(rec):
    return per_inner_step(lambda step: step.stream_ms("attention"))
