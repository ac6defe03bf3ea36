"""The check that decides ``correct``: the plain reference agrees with the
port's CPU path, the control (the reference in TF32 in the program's
place) and the faults a cell can have come out not correct, and the sound
program correct."""

import time

import pytest
import torch

from portbench.tests.bench_fixtures import (SMALL_LIMITS, cuda,  # noqa: F401
                                           small)
from portbench import calibrate, run
from portbench.reference import common

CELLS = ["mvdr-noisy-b32", "gss3-noisy-b32", "mvdr-quiet-b32",
         "gss3-quiet-b32"]


def go(cell, small, serve=None, extra=None, seed=2**31 + 11):
    node = run.load_cell(cell)["cfg"]["node"]
    ov = dict(small, limits={"out_gap": SMALL_LIMITS[node]})
    if extra:
        ov = run._merge(ov, extra)
    return run.run_cell(cell, seed, 0.3, False, device="cpu", overrides=ov,
                        serve=serve, t_start=time.perf_counter())


@pytest.mark.parametrize("cell", ["mvdr-quiet-b32", "gss3-quiet-b32"])
def test_reference_equals_the_ports_cpu_path_in_float64(cell, small):
    """float64 on both sides: the reference follows the port to round-off,
    GSS from the port's state in the middle of a stream too."""
    out = go(cell, small, extra={"cfg": {"engine": {"dtype": "float64"}}})
    assert out["checks"]["out_gap"]["value"] < 1e-10


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell, small):
    out = go(cell, small)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, small):
    node = run.load_cell(cell)["cfg"]["node"]
    out = go(cell, small, serve=calibrate.control(node))
    assert not out["correct"], out["checks"]


class Broken:
    """The port's runner with one fault planted under its ``process``."""

    def __init__(self, fault, cfg, hop, dev, b):
        from beamform_tpu_torch.config import EngineConfig, parse_array_config
        from beamform_tpu_torch.runtime.batch import BatchRunner
        doc = dict(cfg["array"])
        for i, a in enumerate(cfg.get("interference_angles", [])):
            doc[f"angle_interf{i + 1}"] = a
        self.inner = BatchRunner(
            cfg["node"], EngineConfig(window_size=hop), parse_array_config(doc),
            dict(cfg["params"]), batch=b, device=dev)
        self.fault = fault

    @property
    def state(self):
        return self.inner.state

    def process(self, x, theta):
        if self.fault == "state_unchanged":
            st = self.inner.state
            out = self.inner.process(x, theta)
            self.inner.state = st
            return out
        if self.fault == "half_batch":
            out = self.inner.process(x, theta).clone()
            out[out.shape[0] // 2:] = 0.0
            return out
        out = self.inner.process(x, theta).clone()      # answer_altered
        out[0, out.shape[1] // 3] += 0.05 * out[0].abs().max()
        return out


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", ["mvdr-noisy-b32", "gss3-noisy-b32"])
def test_faults_are_not_correct(cell, fault, small):
    """Each fault a one-card serving cell can have (no exchange between
    cards here), planted under the timed path: not correct."""

    def serve(cfg, thetas, hop, fs, dev):
        return Broken(fault, cfg, hop, dev, len(thetas))

    out = go(cell, small, serve=serve)
    assert not out["correct"], out["checks"]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -12)])
    assert common.tf32_round(x).tolist() == [1.0 + 2.0 ** -10,
                                             1.0 + 2.0 ** -10, 1.0,
                                             -(1.0 + 2.0 ** -10)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card_at_the_cells_size(cell, cuda):
    node = run.load_cell(cell)["cfg"]["node"]
    out = run.run_cell(cell, 7, 1.0, False, serve=calibrate.control(node),
                       t_start=time.perf_counter())
    assert not out["correct"], out["checks"]
