"""K3, the submanifold convs' backward
(`ops.gather_conv_bwd.subm_conv_bwd`): the stream ms of the system's
`k3` spans a traced step, summed (they run on autograd's thread, inside
the `backward` span)."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "train":
        return None
    return program_spans.stream_ms("train_step", "k3")
