"""srfdet3d_torch: the SRFDet 3D detector in PyTorch for NVIDIA Hopper.

A port of the JAX package `srfdet3d_tpu`, module for module.  Plain tensor
code is PyTorch; every Pallas kernel of the JAX package becomes a CUDA C++
kernel in `csrc/`, built at first use and bound with ctypes.  Each kernel's
wrapper runs its plain PyTorch version for tensors on the CPU (that is what
the tests compare with the JAX package) and launches the kernel, or raises,
for tensors on the card.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another.  Raises when CUDA is asked for and there is no card; never
    moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "srfdet3d_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev


def set_backend_flags() -> None:
    """Full float32 matmuls and convolutions (no TF32): the JAX package is
    f32-faithful, and the port is held against it.  cuDNN times its
    candidate algorithms once per conv shape: with TF32 off, its heuristic
    alone picks an FFT algorithm for SECOND's first conv (256 -> 128
    channels, 3x3, on the 184 x 184 flagship BEV map) that takes most of
    predict's time and a workspace of many GB (PERF.md, "H100 port").
    A caller that turned on `torch.backends.cudnn.deterministic` keeps
    cuDNN's heuristic choice instead (no timing, whose pick can differ
    from run to run): benchmark stays off while deterministic is on.
    bfloat16 matmuls (the bf16 compute modes) sum in float32 and round
    once, as the JAX package's dots do: no bf16 partial sums in cuBLAS's
    split reductions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = not torch.backends.cudnn.deterministic
