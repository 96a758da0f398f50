"""Host round trips of the rotated-NMS loop a frame (the system's
`geometry.iou.last_nms_sweeps`, read after each traced frame)."""


def read(ctx):
    if ctx.mode != "predict" or not ctx.nms_sweeps:
        return None
    return sum(ctx.nms_sweeps) / len(ctx.nms_sweeps)
