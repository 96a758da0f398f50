"""Device kernels launched a served frame (the host's eager dispatch)."""


def read(ctx):
    if ctx.mode != "predict" or not ctx.frames:
        return None
    return ctx.trace.launches() / ctx.frames
