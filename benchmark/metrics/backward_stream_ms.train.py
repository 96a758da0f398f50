"""A traced step's the backward (`total.backward()`), the
sparse convs' K3 and K4 and the RoIAlign's K5 inside it: stream ms of the
system's `backward` span inside `train_step`."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "train":
        return None
    return program_spans.stream_ms("train_step", "backward")
