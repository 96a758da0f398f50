"""The export CLI (`python -m srfdet3d_torch.tools.export`) with
`--bake-params --device cpu` and a port checkpoint, and a fresh process
that loads its artifact with nothing of the model's code.

`main([...])` exports `tiny_test_config` from a weights-only checkpoint
(a seeded model with its class biases zeroed, so decoding keeps boxes)
and writes a loadable `.pt2` that takes only the batch.  Loaded here, its
outputs on the synthetic batch meet the export bar against the live
predict of the checkpoint's weights (scores and boxes within rtol 1e-5 and
atol 1e-6, labels and valid exactly).  A subprocess imports torch and the
op library alone (`srfdet3d_torch.ops.library`), loads the file, calls it
and saves its outputs: `srfdet3d_torch.models` is never imported there,
every `srfdet::` op is registered, and the outputs meet the bar against
the live predict."""

import os
import subprocess
import sys

import pytest
import torch

from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.tools import export
from srfdet3d_torch.utils.checkpoint import save_checkpoint
from torch_port_common import (check_artifact_outputs, detecting_port,
                               graph_targets)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LOADER = """
import sys
import torch
import srfdet3d_torch.ops.library
prog = torch.export.load(sys.argv[1])
out = prog.module()(torch.load(sys.argv[2]))
torch.save(out, sys.argv[3])
assert "srfdet3d_torch.models" not in sys.modules
for op in ("gather_conv", "eqmatch_rulebook", "plan_map", "key_hash",
           "rulebook_lookup"):
    getattr(torch.ops.srfdet, op).default
print(sorted(m for m in sys.modules if m.startswith("srfdet3d_torch")))
"""


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export_cli")
    cfg = tconfigs.tiny_test_config()
    port = detecting_port(cfg, seed=0)
    ckpt = str(tmp / "tiny.pt")
    save_checkpoint(ckpt, port)
    out = str(tmp / "tiny_baked.pt2")
    rec = export.main(["--config", "tiny", "--out", out, "--checkpoint",
                       ckpt, "--bake-params", "--batch-size", "1",
                       "--device", "cpu"])
    batch = export.example_batch(cfg, 1, device="cpu")
    loaded = export.load_artifact(out)
    return dict(tmp=tmp, out=out, rec=rec, port=port, batch=batch,
                loaded=loaded, got=loaded.module()(batch),
                live=port.predict(batch))


def test_cli_writes_a_loadable_baked_artifact(case):
    assert os.path.getsize(case["out"]) == case["rec"]["bytes"] > 0
    # the batch's points and mask are its only inputs
    assert len(case["loaded"].graph_signature.user_inputs) == 2
    assert case["loaded"].state_dict          # the weights travel in it
    for name, t in case["port"].state_dict().items():
        if name in case["loaded"].state_dict:
            assert torch.equal(case["loaded"].state_dict[name], t), name
    targets = graph_targets(case["loaded"])
    assert "srfdet.gather_conv.default" in targets
    assert "srfdet.eqmatch_rulebook.default" in targets


def test_cli_round_trip_matches_live_predict(case):
    check_artifact_outputs(case["got"], case["live"])
    assert case["got"]["valid"].sum() > 0


def test_fresh_process_loads_without_model_code(case):
    tmp = case["tmp"]
    batch_path, out_path = str(tmp / "batch.pt"), str(tmp / "out.pt")
    torch.save(case["batch"], batch_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _LOADER, case["out"], batch_path, out_path],
        cwd=str(tmp), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "srfdet3d_torch.ops.library" in proc.stdout
    # another process sums in its own thread count's order: the bar
    check_artifact_outputs(torch.load(out_path), case["live"])
