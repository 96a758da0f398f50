"""K3's share of its roofline in the traced steps: the bound of every
submanifold conv's backward for the hits its rulebook holds
(roofline.k3_cost) over the device time of the gather-GEMM and dW
kernels launched inside the system's submanifold backward call."""

from benchmark import roofline

KERNELS = ("gather_gemm::kernel", "dw_partial_kernel", "dw_reduce_kernel")


def read(ctx):
    if ctx.mode != "train" or not ctx.convs:
        return None
    spent = ctx.trace.span_s("k3", KERNELS)
    if spent <= 0.0:
        return None
    bound = sum(roofline.k3_bound_s(c) for c in ctx.convs)
    return 100.0 * bound / spent
