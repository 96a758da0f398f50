"""The lower-precision control fails the check (on the card, at the
cell's own size): the reference with TF32 on, in the system's place,
against the cell's limits.  Run on the chip with
`python3 -m pytest benchmark/tests -m card`."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, compare
from benchmark.registry import Registry

from .bench_common import need_card


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      Registry().spec["workloads"]])
def test_tf32_control_fails(workload):
    need_card()
    reg = Registry()
    cell = reg.cell(workload)
    doc, traffic = reg.config(cell), reg.traffic(cell)
    fn = (calibrate.control_predict if traffic["mode"] == "predict"
          else calibrate.control_train)
    readings = fn(doc, traffic, 20261018, torch.device("cuda"))
    correct, _ = compare.judge(readings, calibrate.held(readings,
                                                       reg.limits(cell)))
    assert not correct, readings
