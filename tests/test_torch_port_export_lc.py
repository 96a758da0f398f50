"""The predict export of an LC model: `tiny_lc_test_config("vovnet")` (two
64 x 128 cameras, VoVNet-19-slim and the image FPN), its weights passed
in.

The export traces on the JAX `build_predict`'s example inputs (zero
images, identity lidar2img); the loaded artifact is then called on seeded
images and a seeded surround rig (chip_smoke's `lc_batch`), whose shapes
are the export's, and held against the live port predict: scores and
boxes within rtol 1e-5 and atol 1e-6, labels and valid exactly.  The
graph holds the LiDAR branch's kernels and the NMS loop, and no host
read."""

import pytest

import chip_smoke
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.tools import export
from torch_port_common import (check_artifact_outputs, detecting_port,
                               graph_targets)

B = 2


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    cfg = tconfigs.tiny_lc_test_config("vovnet")
    port = detecting_port(cfg, seed=2)
    path = str(tmp_path_factory.mktemp("export_lc") / "lc.pt2")
    prog = export.export_predict(cfg, path, model=port, batch_size=B)
    example = export.example_batch(cfg, B, device="cpu")
    assert not example["images"].any()
    loaded = export.load_artifact(path)
    batch = chip_smoke.lc_batch(cfg, B, seed=3)
    assert {k: v.shape for k, v in batch.items()} == \
        {k: v.shape for k, v in example.items()}
    got = loaded.module()(port.state_dict(), batch)
    return dict(port=port, prog=prog, loaded=loaded, got=got,
                live=port.predict(batch))


def test_lc_round_trip_matches_live_predict(case):
    check_artifact_outputs(case["got"], case["live"])
    assert case["got"]["valid"].sum() > 0


def test_lc_graph_holds_the_kernels(case):
    want = chip_smoke.predict_launches(case["port"])
    targets = graph_targets(case["loaded"])
    assert targets.count("srfdet.gather_conv.default") == \
        want["gather_conv"]
    assert targets.count("srfdet.eqmatch_rulebook.default") == \
        want["eqmatch"]
    assert targets.count("while_loop") == 1
    assert "aten._local_scalar_dense.default" not in targets
