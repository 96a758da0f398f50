"""Share of the card's idle time in the traced window during which the
host is inside `SRFDet.predict` (the system's `srfdet/predict` range in
the profiler's trace, on the kernels' clock); the rest falls in the
caller's copies of frames in and answers out, and its loop."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "predict" or ctx.trace is None:
        return None
    return program_spans.idle_inside_pct(
        ctx.trace, program_spans.PREFIX + "predict")
