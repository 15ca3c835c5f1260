"""attack.backward_host_ms: the host time of the patch gradient (the
program's `attack.backward` span around `torch.autograd.grad`, the blocks'
recomputation included), per inner step of the first outer step the
program recorded."""

from vlabench.common.spans import per_inner_step


def read(rec):
    return per_inner_step(lambda step: step.host_ms("attack.backward"))
