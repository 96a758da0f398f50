"""Share of a predict frame's time in which no operation ran on the card:
100 (1 - busy / time), busy the card's busy seconds a frame in the traced
part of the window (the union of kernel, memcpy and memset intervals),
time the seconds a frame takes in the untraced part before it, as the
profiler slows the host and so stretches the traced part's idle gaps."""


def read(ctx):
    if (ctx.mode != "predict" or not ctx.frames or not ctx.plain_frames
            or ctx.plain_s <= 0.0):
        return None
    busy = ctx.trace.busy_s() / ctx.frames
    return 100.0 * (1.0 - busy / (ctx.plain_s / ctx.plain_frames))
