"""Device ms a frame launched inside the head's forward span (DPG,
attention, RoIAlign, the refinement iterations)."""

SPANS = ("bbox_head",)


def read(ctx):
    if ctx.mode != "predict" or not ctx.frames:
        return None
    total = sum(ctx.trace.span_s(s) for s in SPANS)
    if total <= 0.0:
        return None
    return 1e3 * total / ctx.frames
