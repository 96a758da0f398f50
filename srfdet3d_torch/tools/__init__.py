"""The port's command-line entry points: `python -m srfdet3d_torch.tools.train`
and `python -m srfdet3d_torch.tools.test` (the JAX package's
`tools/train.py` and `tools/test.py`)."""
