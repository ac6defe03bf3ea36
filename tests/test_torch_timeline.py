"""The port's interference timelines, steering matrices and kernel build key
against the JAX package.

The timeline module is a jax-free copy: the same events give the same
arrays, bit for bit, including ``unique_control_rows``' row order and
inverse index. Steering weights with a per-row mic-0 scale are held to the
JAX function at 1e-12 (float64, the same cos/sin arithmetic).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beamform_tpu import geometry as jgeom
from beamform_tpu.runtime import timeline as jtl
from beamform_tpu_torch import geometry as tgeom
from beamform_tpu_torch.kernels import _build
from beamform_tpu_torch.models.batching import trim_inactive_slots
from beamform_tpu_torch.runtime import timeline as ttl

from conftest import AIRA3

EVENTS = [(2, 1, 50.0), (4, 3, -90.0), (6, 5, -88.0), (8, 1, -33.0),
          (9, 0, 10.0), (11, 3, 120.0)]


def _events(mod, events):
    return [mod.InterfEvent(frame=f, id=i, angle=a) for f, i, a in events]


def _assert_timelines_equal(a, b):
    for name in ("angles", "active", "row0", "reset"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(threshold=5.0, capacity=4),
    dict(threshold=1.0, capacity=15),
    dict(threshold=5.0, capacity=4, bug_row0_zero_after_realloc=False)])
def test_replay_equals_jax(kw):
    args = (14, [40.0, -30.0])
    _assert_timelines_equal(
        ttl.replay_interference_events(*args, _events(ttl, EVENTS), **kw),
        jtl.replay_interference_events(*args, _events(jtl, EVENTS), **kw))
    assert ttl.MAX_INTERFERENCES == jtl.MAX_INTERFERENCES == 15


def test_static_and_machine_rows_equal_jax():
    for angles, cap in (([], None), ([60.0, -75.0], None), ([60.0], 5)):
        _assert_timelines_equal(ttl.static_interference(7, angles, cap),
                                jtl.static_interference(7, angles, cap))
    tm = ttl.InterferenceMachine([10.0], threshold=1.0, capacity=3)
    jm = jtl.InterferenceMachine([10.0], threshold=1.0, capacity=3)
    for _, i, a in EVENTS:
        assert tm.apply(i, a) == jm.apply(i, a)
        _assert_timelines_equal(tm.rows(5, reset_first=True),
                                jm.rows(5, reset_first=True))
    with pytest.raises(ValueError, match="capacity"):
        ttl.InterferenceMachine([1.0, 2.0], capacity=1)


def test_unique_control_rows_equal_jax():
    """Row order and the inverse index, with a theta timeline on top."""
    th = np.repeat([10.0, -40.0, 10.0, 25.0], 4)[:14]
    tl = [m.replay_interference_events(14, [40.0, -30.0], _events(m, EVENTS),
                                       capacity=4) for m in (ttl, jtl)]
    got = ttl.unique_control_rows(th, tl[0])
    ref = jtl.unique_control_rows(th, tl[1])
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_trim_inactive_slots():
    act = np.array([[1, 1, 0, 0], [1, 0, 0, 0]], bool)
    ang = np.arange(8.0).reshape(2, 4)
    a, b = trim_inactive_slots(ang, act)
    np.testing.assert_array_equal(a, ang[:, :2])
    np.testing.assert_array_equal(b, act[:, :2])
    a, b = trim_inactive_slots(ang, np.zeros_like(act))
    assert a.shape == (2, 0) and b.shape == (2, 0)


def test_steering_weights_batched_row0_matches_jax():
    geom_t = tgeom.ArrayGeometry.from_xy(AIRA3)
    geom_j = jgeom.ArrayGeometry.from_xy(AIRA3)
    freqs = np.linspace(0.0, 8000.0, 9)
    angles = np.array([[20.0, 60.0, -75.0], [25.0, 70.0, 0.0]])    # (U, S)
    row0 = np.array([1.0, 0.0])
    tau = tgeom.steering_delays(geom_t, torch.as_tensor(angles))
    got = tgeom.steering_weights(torch.as_tensor(freqs), tau,
                                 row0_scale=torch.as_tensor(row0)[:, None])
    for u in range(2):
        ref = jgeom.steering_weights(
            freqs, jgeom.steering_delays(geom_j, angles[u]),
            row0_scale=row0[u])
        np.testing.assert_allclose(got[u].numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-12)
    # a scalar scale is unchanged
    ref = jgeom.steering_weights(freqs, np.asarray(tau), row0_scale=0.5)
    got = tgeom.steering_weights(torch.as_tensor(freqs), tau, row0_scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("row0", [1.0, 0.0])
@pytest.mark.parametrize("mask", [None, [1.0, 1.0, 0.0]])
def test_steering_matrix_matches_jax(row0, mask):
    geom_t = tgeom.ArrayGeometry.from_xy(AIRA3)
    geom_j = jgeom.ArrayGeometry.from_xy(AIRA3)
    freqs = np.linspace(0.0, 8000.0, 9)
    doi, interf = 20.0, np.array([60.0, -75.0])
    ref = jgeom.steering_matrix(
        jnp.asarray(freqs), jgeom.steering_delays(geom_j, doi),
        jgeom.steering_delays(geom_j, interf), row0_scale=row0,
        active_mask=None if mask is None else jnp.asarray(mask))
    got = tgeom.steering_matrix(
        torch.as_tensor(freqs), tgeom.steering_delays(geom_t, doi),
        tgeom.steering_delays(geom_t, interf), row0_scale=row0,
        active_mask=mask)
    assert got.shape == (9, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def test_build_key_hashes_headers(tmp_path):
    """A header edit must change the library's key, or a stale library
    built from the old header would load."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    k1 = _build._key(str(tmp_path))
    assert _build._key(str(tmp_path)) == k1
    (tmp_path / "h.cuh").write_text("// two\n")
    k2 = _build._key(str(tmp_path))
    assert k2 != k1
    (tmp_path / "b.cuh").write_text("")
    assert _build._key(str(tmp_path)) != k2
    assert os.path.exists(os.path.join(_build.CSRC, "stream_solve.cuh"))
