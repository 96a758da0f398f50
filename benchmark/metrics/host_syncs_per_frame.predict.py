"""Host syncs a traced frame: the system's `host_sync` counter over its
`predict` span (reads of device values on the host, and copies from host
memory that wait for the stream)."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "predict":
        return None
    return program_spans.counted("predict", "host_sync")
