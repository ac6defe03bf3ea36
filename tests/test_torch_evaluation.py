"""The port's evaluation harness (``beamform_tpu_torch/evaluation.py``)
against the JAX package's, on the CPU, and the port's examples.

Scenes, alignment and metrics are numpy in both packages: equal to
1e-12. ``evaluate_separation`` runs each package's own model (float64,
tests/test_evaluation.py's two-source scene on its 4-mic array) and the
reports agree within 0.01 dB. The examples run in subprocesses that set
``cwd`` and ``PYTHONPATH`` themselves, on short inputs.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from beamform_tpu import evaluation as jev
from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.config import GssParams as JGss
from beamform_tpu.config import LcmvParams as JLcmv
from beamform_tpu.config import PhaseParams as JPhase
from beamform_tpu.geometry import ArrayGeometry as JGeom
from beamform_tpu.models.das import DasModel as JDas
from beamform_tpu.models.gss import GssModel as JGssModel
from beamform_tpu.models.lcmv import LcmvModel as JLcmvModel
from beamform_tpu.models.phase import PhaseModel as JPhaseModel
from beamform_tpu_torch import evaluation as tev
from beamform_tpu_torch.config import (EngineConfig, GssParams, LcmvParams,
                                       PhaseParams)
from beamform_tpu_torch.geometry import ArrayGeometry
from beamform_tpu_torch.models.das import DasModel
from beamform_tpu_torch.models.gss import GssModel
from beamform_tpu_torch.models.lcmv import LcmvModel
from beamform_tpu_torch.models.phase import PhaseModel

from test_evaluation import ARRAY, FS, HOP, _sources

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT_DB = 0.01
EXAMPLE_TIMEOUT_S = 60


def _scenes(delay):
    s1, s2, _ = _sources()
    args = ([s1, s2], [0.0, 90.0], FS)
    return (jev.synth_scene(JGeom.from_xy(ARRAY), *args, noise_std=0.001,
                            delay=delay),
            tev.synth_scene(ArrayGeometry.from_xy(ARRAY), *args,
                            noise_std=0.001, delay=delay))


@pytest.mark.parametrize("delay", ["linear", "spectral"])
def test_synth_scene_is_the_jax_packages(delay):
    want, got = _scenes(delay)
    for field in ("mixture", "images", "noise"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   atol=1e-12, rtol=0, err_msg=field)
    assert got.angles == want.angles and got.sample_rate == want.sample_rate


def test_metrics_are_the_jax_packages():
    """si_sdr, sir_db, bss_project (and align_to_ref) on the same
    estimates."""
    rng = np.random.default_rng(6)
    n = 20000
    tgt, itf = rng.standard_normal(n), rng.standard_normal(n)
    h = np.array([0.5, -0.3, 0.2, 0.1, -0.05])
    est = np.convolve(tgt, h)[:n] + 0.05 * itf
    for fn, args in ((lambda m: m.si_sdr, (est, tgt)),
                     (lambda m: m.sir_db, (est, tgt, itf))):
        assert abs(fn(tev)(*args) - fn(jev)(*args)) <= 1e-12
    for taps in (1, 8):
        got = tev.bss_project(est, tgt, itf, taps)
        want = jev.bss_project(est, tgt, itf, taps)
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-12, (taps, key)
    np.testing.assert_array_equal(tev.align_to_ref(est, HOP),
                                  jev.align_to_ref(est, HOP))


def _models(name):
    """(JAX model, port model) of ``name`` on the scene's array, float64,
    with tests/test_evaluation.py's parameters."""
    je = JEngine(sample_rate=FS, window_size=HOP, dtype="float64")
    te = EngineConfig(sample_rate=FS, window_size=HOP, dtype="float64")
    jg, tg = JGeom.from_xy(ARRAY), ArrayGeometry.from_xy(ARRAY)
    if name == "das":
        return JDas(je, jg), DasModel(te, tg, device="cpu")
    if name == "phase":
        kw = dict(min_phase=40.0, mag_mult=0.05, mag_threshold=0.0)
        return (JPhaseModel(je, jg, JPhase(**kw)),
                PhaseModel(te, tg, PhaseParams(**kw), device="cpu"))
    if name == "lcmv":
        kw = dict(past_windows=6, freq_mag_threshold=1e-4,
                  freq_max=20000.0, freq_min=50.0, out_amp=1.0)
        return (JLcmvModel(je, jg, JLcmv(**kw), interference_angles=(90.0,)),
                LcmvModel(te, tg, LcmvParams(**kw),
                          interference_angles=(90.0,), device="cpu"))
    kw = dict(freq_mag_threshold=1e-4, freq_max=16000.0, freq_min=100.0,
              out_amp=1.0, mu=0.001)
    return (JGssModel(je, jg, JGss(**kw), interference_angles=(90.0,)),
            GssModel(te, tg, GssParams(**kw), interference_angles=(90.0,),
                     device="cpu"))


@pytest.mark.parametrize("name", ["das", "lcmv", "gss", "phase"])
def test_evaluate_separation_is_the_jax_packages(name):
    want_scene, scene = _scenes("linear")
    jm, tm = _models(name)
    kw = dict(theta=0.0, skip=4 * HOP, taps=8)
    want = jev.evaluate_separation(jm, want_scene, **kw)
    got = tev.evaluate_separation(tm, scene, **kw)
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= REPORT_DB, (name, key, got, want)


def _run_example(args, tmp_path):
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path
                                              if path else ""))
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=EXAMPLE_TIMEOUT_S)


def test_torch_demo_runs_on_the_cpu(tmp_path):
    out = _run_example([os.path.join("examples", "torch_demo.py"), "--cpu",
                        "--seconds", "0.4", "--outdir", str(tmp_path)],
                       tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(tmp_path / "report.json") as f:
        table = json.load(f)
    assert set(table) == {"das", "phase", "mvdr", "lcmv", "gss", "gsc",
                          "phasempf", "mcra"}
    assert table["das"]["sir_gain_db"] > 1.0, table["das"]
    assert all(os.path.exists(tmp_path / f"{n}.wav") for n in table)


def test_torch_two_process_doa_steers_the_beamformer(tmp_path):
    """The port's CLI beamformer and the DOA refiner as two processes,
    coupled only by the PCM pipe and the --theta-control file: the DOA
    process moves theta from THETA0 (10 degrees) toward TARGET (20)."""
    control = tmp_path / "theta_ctl.txt"
    out = _run_example([os.path.join("examples", "torch_two_process_doa.py"),
                        "--device", "cpu", "--seconds", "4", "--control",
                        str(control)], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout.strip().splitlines()[0])
    assert rep["updates"] > 100, rep
    assert control.exists()
    assert abs(rep["theta_final"] - rep["target"]) < 5.0, rep
