"""Device ms a frame launched inside the SECOND and FPN forward spans."""

SPANS = ("pts_backbone", "pts_neck")


def read(ctx):
    if ctx.mode != "predict" or not ctx.frames:
        return None
    total = sum(ctx.trace.span_s(s) for s in SPANS)
    if total <= 0.0:
        return None
    return 1e3 * total / ctx.frames
