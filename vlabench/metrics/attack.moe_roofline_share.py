"""attack.moe_roofline_share: the routed experts' grouped products at their
bound over their device time, in %, in the traced outer step (device
activity only). The device time is the kernels' whose trace names hold
these words (PyTorch's grouped GEMM on sm90: CUTLASS's
`GemmUniversal<GroupProblemShape ...>` and its `prepare_grouped_gemm_data`
launch); the bound is `common/moe_flops.routed_expert_bound_s` per inner
step (each expert's matrix and the routed rows read once, the outputs
written once, or the FLOPs at the bf16 peak) times the step's inner steps.
None where no such kernel ran."""

KERNEL_WORDS = ("groupproblemshape", "prepare_grouped_gemm")


def read(rec):
    tr = rec.get("trace")
    if tr is None or "moe_bound_s" not in rec:
        return None
    seconds = tr.seconds_matching(KERNEL_WORDS)
    if seconds <= 0:
        return None
    return 100.0 * rec["moe_bound_s"] * rec["inner_loop"] / seconds
