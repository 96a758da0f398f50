"""A traced step's the AdamW update (`opt.step()`): stream ms of the
system's `optimizer` span inside `train_step`."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "train":
        return None
    return program_spans.stream_ms("train_step", "optimizer")
