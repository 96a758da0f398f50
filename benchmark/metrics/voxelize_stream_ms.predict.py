"""The voxelizer and the VFE a traced frame: stream ms of the system's
`voxelize` span (`SRFDet.voxel_features`), the card's time from reaching
the span's start to reaching its end."""

from benchmark import program_spans


def read(ctx):
    if ctx.mode != "predict":
        return None
    return program_spans.stream_ms("predict", "voxelize")
