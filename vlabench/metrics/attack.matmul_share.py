"""attack.matmul_share: device time in matrix-product kernels (cuBLAS and
CUTLASS GEMM and GEMV kernels, by their trace names) over the device's busy
time, in the traced outer step."""

GEMM_WORDS = ("gemm", "gemv", "nvjet", "xmma")


def read(rec):
    tr = rec.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * tr.seconds_matching(GEMM_WORDS) / tr.busy_s
