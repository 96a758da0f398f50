"""The predict export on the table rulebook backend: `tiny_kitti_test_config`
with `middle.rulebook="table"` (dynamic voxelization, code size 8), its
weights passed in.

The artifact (saved, then loaded through the op library) against the live
port predict on seeded points: scores and boxes within rtol 1e-5 and atol
1e-6, labels and valid exactly.  Its graph holds what an eager predict
launches on the card (chip_smoke's `predict_launches` and
`predict_builds` from the model's structure): one `srfdet::gather_conv`
a gathered conv, one `srfdet::rulebook_lookup` a lookup, one
`srfdet::key_hash` a stage's key table, no eq-match; the NMS
`while_loop`; no host read."""

import dataclasses

import pytest

import chip_smoke
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.tools import export
from torch_port_common import (check_artifact_outputs, detecting_port,
                               graph_targets)

B = 2


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    base = tconfigs.tiny_kitti_test_config()
    cfg = base.replace(middle=dataclasses.replace(base.middle,
                                                  rulebook="table"))
    port = detecting_port(cfg, seed=1)
    path = str(tmp_path_factory.mktemp("export_table") / "kitti.pt2")
    prog = export.export_predict(cfg, path, model=port, batch_size=B)
    loaded = export.load_artifact(path)
    batch = export.synthetic_batch(cfg, B, seed=4)
    got = loaded.module()(port.state_dict(), batch)
    return dict(port=port, prog=prog, loaded=loaded, got=got,
                live=port.predict(batch))


def test_table_round_trip_matches_live_predict(case):
    assert not case["port"].pts_middle_encoder.use_bitmap
    check_artifact_outputs(case["got"], case["live"])
    assert case["got"]["valid"].sum() > 0


def test_table_graph_holds_the_lookups(case):
    want = chip_smoke.predict_launches(case["port"])
    builds = chip_smoke.predict_builds(case["port"])
    assert want["rulebook_lookup"] > 0 and builds["key_hash"] > 0
    for prog in (case["prog"], case["loaded"]):
        targets = graph_targets(prog)
        assert targets.count("srfdet.gather_conv.default") == \
            want["gather_conv"]
        assert targets.count("srfdet.rulebook_lookup.default") == \
            want["rulebook_lookup"]
        assert targets.count("srfdet.key_hash.default") == builds["key_hash"]
        assert "srfdet.eqmatch_rulebook.default" not in targets
        assert targets.count("while_loop") == 1
        assert "aten._local_scalar_dense.default" not in targets
