"""mfu.attack: the model FLOPs of the inner steps the window completed
(forward + input gradient from the configuration's sizes, recomputation not
counted) over the window's seconds, as a share of the card's dense bf16
peak."""


def read(rec):
    if not rec.get("inner_steps"):
        return None
    return 100.0 * rec["inner_steps"] * rec["flops_per_inner_step"] / rec["window_s"] / rec["peak_flops"]
