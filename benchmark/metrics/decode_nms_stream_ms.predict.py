"""Decode and rotated NMS a traced frame: stream ms of the system's
`decode` span (`SRFDet.decode`)."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "predict":
        return None
    return program_spans.stream_ms("predict", "decode")
