"""Helpers of the benchmark's CPU tests: a cell's files cut to a tiny
config and a small scene, run on the CPU with the plain versions."""

from __future__ import annotations

import dataclasses

import pytest
import torch


def tiny_tweak(lc: bool):
    """tweak(doc, traffic) for run.run: the port's tiny config (tiny LC for
    an LC cell) in place of the config's fields, and a scene that fits its
    +-10 m grid."""
    from srfdet3d_torch.configs import get_config, tiny_lc_test_config

    def tweak(doc, traffic):
        tiny = tiny_lc_test_config("vovnet") if lc else get_config("tiny")
        fields = dataclasses.asdict(tiny)
        for k in list(doc):
            if k in fields:
                doc[k] = fields[k]
        s = traffic["scene"]
        s.update(azimuth_steps=64, sweeps=2, beams=8, object_area=16.0,
                 objects=[3, 6], walls=[1, 2], wall_distance=[6.0, 9.0])
        s["classes"] = s["classes"][:len(doc["class_names"])]
        traffic["pool"] = min(traffic["pool"], 3)
        traffic["batch"] = min(traffic["batch"], 2)
    return tweak


def need_card():
    """Skip (inside the test) unless a CUDA card is here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the card tests run on the chip")
