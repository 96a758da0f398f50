"""Host syncs a traced step: the system's `host_sync` counter over its
`train_step` span."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "train":
        return None
    return program_spans.counted("train_step", "host_sync")
