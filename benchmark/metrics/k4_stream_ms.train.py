"""K4, the strided convs' backward
(`ops.gather_conv_bwd.strided_conv_bwd`): the stream ms of the system's
`k4` spans a traced step, summed (they run on autograd's thread, inside
the `backward` span)."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "train":
        return None
    return program_spans.stream_ms("train_step", "k4")
