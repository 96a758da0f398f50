"""Replays of the system's tail graph a traced frame (the static-shape
tail of predict, from the sparse encoder's output to the head's, as one
CUDA graph): its `tail_graph.replays` counter over the `predict` span.
1 where every frame replays it, 0 where predict runs eagerly (an LC frame
with its cameras).  A system without the tail graph reads nothing."""

import importlib.util

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "predict":
        return None
    try:
        found = importlib.util.find_spec(
            "srfdet3d_torch.models.tail_graph") is not None
    except ImportError:
        found = False
    if not found:
        return None
    return program_spans.counted("predict", "tail_graph.replays")
