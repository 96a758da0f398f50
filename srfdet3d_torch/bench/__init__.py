"""Card-only measurement scripts of the port, each run as
``python3 -m srfdet3d_torch.bench.<name>`` from the root of a checkout."""
