"""The port's command-line entry points (the JAX package's `tools/`):
`python -m srfdet3d_torch.tools.train`, `...tools.test`,
`...tools.convert_checkpoint` (a reference .pth into the port's
checkpoint), `...tools.export` (the whole predict as one torch.export
artifact), `...tools.eval_results_from_pkl` (the test CLI's
--eval-from-pkl), `...tools.create_data` (info pickles and the GT
database from raw KITTI, Waymo-as-KITTI and nuScenes trees),
`...tools.show_results_from_pkl` and `...tools.mix_imgs_convert_video`
(drawing results; they need cv2)."""
