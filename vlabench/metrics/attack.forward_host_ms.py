"""attack.forward_host_ms: the host time of the model forward (the
program's `attack.forward` span around `vla_forward` in
`attacks/engine.patch_loss_and_grad`), per inner step of the first outer
step the program recorded."""

from vlabench.common.spans import per_inner_step


def read(rec):
    return per_inner_step(lambda step: step.host_ms("attack.forward"))
