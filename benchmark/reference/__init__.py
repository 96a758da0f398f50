"""The plain reference of the benchmark: a frozen copy of the detector's
modules (voxelizer, VFE, sparse encoder with its bitmap rulebooks, SECOND,
FPN, VoVNet, the head with its RoIAlign, decode and rotated NMS, the OTA
losses and the flat AdamW step) in plain PyTorch, every CUDA kernel
replaced by its plain version and every backward left to autograd.  It
imports nothing of the system under test and no JAX; it takes the
weights and inputs the benchmark makes and works out everything else
(rulebooks, RoIs, assignments) again.  Float32 with TF32 off, unless a
caller turns TF32 on (the lower-precision control)."""

import torch


def resolve_device(device=None) -> torch.device:
    return torch.device("cuda" if device is None else device)


def set_backend_flags(tf32: bool = False) -> None:
    """Float32 matmuls and convolutions without TF32 (the configs'
    precision); `tf32` turns it on for the control."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
