"""A traced step's the forward in train mode (`model(...)` in
`losses_of`): stream ms of the
system's `forward` span inside `train_step`."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "train":
        return None
    return program_spans.stream_ms("train_step", "forward")
