"""Device ms a frame launched inside the sparse encoder's forward span
(rulebooks, K1, K2, BN)."""

SPANS = ("pts_middle_encoder",)


def read(ctx):
    if ctx.mode != "predict" or not ctx.frames:
        return None
    total = sum(ctx.trace.span_s(s) for s in SPANS)
    if total <= 0.0:
        return None
    return 1e3 * total / ctx.frames
