"""The port's command-line entry points (the JAX package's `tools/`):
`python -m srfdet3d_torch.tools.train`, `...tools.test`,
`...tools.convert_checkpoint` (a reference .pth into the port's
checkpoint) and `...tools.eval_results_from_pkl` (the test CLI's
--eval-from-pkl)."""
