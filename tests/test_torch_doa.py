"""The port's closed-loop steering (``beamform_tpu_torch/doa``) against the
JAX package's ``doa``: the numpy controllers on the same seeded windows,
bit for bit, and ``run_closed_loop`` over each package's DAS session on
the same scene (float64: theta trajectories within 1e-9, output within
1e-6)."""

import numpy as np
import pytest

from beamform_tpu import doa as jdoa
from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.config import parse_array_config as jparse
from beamform_tpu.doa.closed_loop import run_closed_loop as jloop
from beamform_tpu.doa.sir2theta import SpeakerIdStub as JStub
from beamform_tpu.models import get_model as jget_model
from beamform_tpu.runtime.streaming import StreamingSession as JSession
from beamform_tpu_torch import doa as tdoa
from beamform_tpu_torch.config import EngineConfig, parse_array_config
from beamform_tpu_torch.doa.closed_loop import run_closed_loop
from beamform_tpu_torch.models import get_model
from beamform_tpu_torch.runtime.streaming import StreamingSession

from conftest import AIRA3, make_scene

HOP = 128
THETA_TOL = 1e-9
OUT_TOL = 1e-6


def _windows(seed, n, scales=(0.001, 0.1, 0.5)):
    """``n`` hop windows whose level steps through ``scales``: silent,
    active and loud stretches, so every gate and branch is taken."""
    rng = np.random.default_rng(seed)
    lvl = np.repeat(scales, -(-n // len(scales)))[:n]
    rng.shuffle(lvl)
    return [lv * rng.standard_normal(HOP) for lv in lvl]


def test_energy_vad_matches_jax():
    wins = _windows(0, 60)
    a, b = jdoa.EnergyVad(), tdoa.EnergyVad()
    flags = [(a.step(w), b.step(w)) for w in wins]
    assert [f for f, _ in flags] == [g for _, g in flags]
    assert any(f for f, _ in flags) and not all(f for f, _ in flags)
    assert a.enoise == b.enoise and a.windows_passed == b.windows_passed
    np.testing.assert_array_equal(a._ehist, b._ehist)


@pytest.mark.parametrize("mode", ["hist", "rms", "spec"])
def test_gradient_doa_matches_jax(mode):
    wins = _windows(1, 40)
    kw = dict(theta=170.0, mu=400.0, num_win=5, vad_threshold=0.01,
              energy_mode=mode)
    a, b = jdoa.GradientDoa(**kw), tdoa.GradientDoa(**kw)
    ta = [a.step(w) for w in wins]
    tb = [b.step(w) for w in wins]
    assert ta == tb
    assert len(set(ta)) > 3                 # the controller moved


def test_diff_gradient_doa_matches_jax():
    bf, ref = _windows(2, 40), _windows(3, 40)
    kw = dict(theta=-170.0, mu=300.0, num_win=4, vad_threshold=0.01)
    a, b = jdoa.DiffGradientDoa(**kw), tdoa.DiffGradientDoa(**kw)
    ta = a.run(np.concatenate(bf), np.concatenate(ref), HOP)
    tb = b.run(np.concatenate(bf), np.concatenate(ref), HOP)
    np.testing.assert_array_equal(ta, tb)
    assert len(set(ta.tolist())) > 3


@pytest.mark.parametrize("method", ["history", "spectrogram"])
def test_spec_gradient_doa_matches_jax(method):
    bf, ref = _windows(4, 36), _windows(5, 36)
    kw = dict(theta=5.0, num_win=8 if method == "spectrogram" else 4,
              vad_threshold=0.01, energy_calc_method=method)
    ma, mb = jdoa.SpecDoaMonitor(), tdoa.SpecDoaMonitor()
    a = jdoa.SpecGradientDoa(monitor=ma, **kw)
    b = tdoa.SpecGradientDoa(monitor=mb, **kw)
    ta = [a.step(x, r) for x, r in zip(bf, ref)]
    tb = [b.step(x, r) for x, r in zip(bf, ref)]
    assert ta == tb and a.mu == b.mu
    assert len(set(ta)) > 2
    assert ma.rms_series == mb.rms_series
    np.testing.assert_array_equal(ma.energy_series, mb.energy_series)
    assert mb.plotting == ma.plotting


def test_sir_controller_and_stubs_match_jax():
    a, b = jdoa.SirToTheta(theta=1.0, mu=0.01), tdoa.SirToTheta(theta=1.0,
                                                                mu=0.01)
    da, db = jdoa.SirDummy(), tdoa.SirDummy()
    ta, tb = [a.theta], [b.theta]
    for _ in range(200):
        ta.append(a.step(da.measure(ta[-1])))
        tb.append(b.step(db.measure(tb[-1])))
    assert ta == tb and abs(tb[-1]) < 1.0
    sa, sb = JStub(every=3), tdoa.SpeakerIdStub(every=3)
    wins = _windows(6, 20)
    assert [sa.step(w) for w in wins] == [sb.step(w) for w in wins]


def test_spec_monitor_records_without_a_figure(tmp_path):
    mon = tdoa.SpecDoaMonitor(out_path=str(tmp_path / "doa.png"))
    mon.update(0.1, -0.02, 5.0)
    mon.update(0.2, 0.03, float("nan"))
    assert mon.rms_series == [0.1, 0.2]
    assert mon.delta_series == [-0.02, 0.03]
    assert np.isnan(mon.energy_series[1])
    saved = mon.save()
    assert (saved is None) == (not mon.plotting)
    mon.close()


def _sessions(node):
    kw = dict(sample_rate=48000, window_size=HOP, dtype="float64")
    doc = {f"mic{i}": {"id": i, "x": x, "y": y}
           for i, (x, y) in enumerate(AIRA3)}
    return (JSession(jget_model(node, JEngine(**kw), jparse(doc))),
            StreamingSession(get_model(node, EngineConfig(**kw),
                                       parse_array_config(doc),
                                       device="cpu")))


@pytest.mark.parametrize("controller", ["gradient", "diff"])
def test_closed_loop_matches_jax(controller):
    """DAS steered chunk by chunk by a refiner of its own output (and, for
    the diff controller, a ``ref`` session's aligned reference): both
    packages follow the same theta trajectory."""
    x = make_scene(AIRA3, seconds=0.3, theta_deg=30.0, hop=HOP)
    js, ts = _sessions("das")
    kw = dict(theta=0.0, mu=200.0, num_win=4, vad_threshold=0.0)
    if controller == "gradient":
        a = jdoa.GradientDoa(energy_mode="rms", **kw)
        b = tdoa.GradientDoa(energy_mode="rms", **kw)
        refs = (None, None)
    else:
        a, b = jdoa.DiffGradientDoa(**kw), tdoa.DiffGradientDoa(**kw)
        refs = (_sessions("ref")[0], _sessions("ref")[1])
    ya, ta = jloop(js, a, x, chunk_frames=4, ref_session=refs[0])
    yb, tb = run_closed_loop(ts, b, x, chunk_frames=4, ref_session=refs[1])
    assert tb.shape == ta.shape == (x.shape[1] // (4 * HOP) * 4,)
    assert np.ptp(tb) > 0.1                    # the loop really steered
    np.testing.assert_allclose(tb, ta, rtol=0, atol=THETA_TOL)
    np.testing.assert_allclose(yb, np.asarray(ya), rtol=0, atol=OUT_TOL)
