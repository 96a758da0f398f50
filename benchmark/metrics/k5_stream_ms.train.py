"""K5, the BEV RoIAlign's backward scatter
(`ops.roi_scatter.roi_scatter`): the stream ms of the system's
`k5` spans a traced step, summed (they run on autograd's thread, inside
the `backward` span)."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "train":
        return None
    return program_spans.stream_ms("train_step", "k5")
