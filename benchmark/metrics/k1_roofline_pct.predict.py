"""K1's share of its roofline in the served frames: the bound of every
gathered conv of each frame for the hits its rulebook holds
(roofline.k1_cost) over K1's device time, the 3xTF32 gather-GEMM kernel
launched inside the sparse encoder's span."""

from benchmark import roofline

KERNELS = ("gather_gemm::kernel",)


def read(ctx):
    if ctx.mode != "predict" or not ctx.convs:
        return None
    spent = ctx.trace.span_s("pts_middle_encoder", KERNELS)
    if spent <= 0.0:
        return None
    bound = sum(roofline.k1_bound_s(c) for c in ctx.convs)
    return 100.0 * bound / spent
