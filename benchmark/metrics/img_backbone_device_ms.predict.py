"""Device ms a frame launched inside the image backbone's and neck's
forward spans."""

SPANS = ("img_backbone", "img_neck")


def read(ctx):
    if ctx.mode != "predict" or not ctx.frames:
        return None
    total = sum(ctx.trace.span_s(s) for s in SPANS)
    if total <= 0.0:
        return None
    return 1e3 * total / ctx.frames
