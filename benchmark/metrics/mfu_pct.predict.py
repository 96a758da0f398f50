"""The whole predict's share of the card's float32-faithful peak: the
model flops of the frames served in the window's untraced part
(roofline.py: dense layers by a flop counter on the reference, sparse
convs by their rulebook hits) over that part's seconds and the 3xTF32
rate.  The untraced part, as the profiler slows the host."""

from benchmark import roofline


def read(ctx):
    if ctx.mode != "predict" or not ctx.flops or ctx.plain_s <= 0.0:
        return None
    return 100.0 * sum(ctx.flops) / ctx.plain_s / roofline.PEAK_3XTF32
