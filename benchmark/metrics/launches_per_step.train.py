"""Device kernels launched a train step (the host's eager dispatch)."""


def read(ctx):
    if ctx.mode != "train" or not ctx.frames:
        return None
    return ctx.trace.launches() / ctx.frames
