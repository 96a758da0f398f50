"""A traced step's the losses with the OTA assignment
(`srfdet_losses` in `losses_of`): stream ms of the
system's `loss_ota` span inside `train_step`."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "train":
        return None
    return program_spans.stream_ms("train_step", "loss_ota")
