"""attack.expert_load_max_over_mean: the busiest routed expert's rows over
the mean expert's, per sparse-expert layer call, averaged over the calls
of the first outer step the program recorded (the forward's and the
recomputation's, which route alike). Read from the rows per expert that the
program keeps on the device for the step (`moe.expert_tokens`) and reduced
here, after the step. 1 is an even load; a layer's time follows its
busiest expert's. None for a program that keeps no such tensors."""

from vlabench.common.spans import first_step


def read(rec):
    import torch

    step = first_step()
    kept = getattr(step, "kept", {}).get("moe.expert_tokens") if step is not None else None
    if not kept:
        return None
    rows = torch.stack(kept).float()
    return float((rows.amax(dim=-1) / rows.mean(dim=-1)).mean())
