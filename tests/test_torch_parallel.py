"""The port's multi-device layer (``beamform_tpu_torch/parallel``) against
the JAX package's, on the CPU.

A module fixture starts one gloo world of four ranks, once, as
``torchrun`` would on two nodes of two ranks (``LOCAL_WORLD_SIZE`` = 2):
``tests/torch_parallel_worker.py``, a process each, on the (stream, bin)
= (2, 2) mesh of ``multihost_mesh`` (bin groups inside a node) and the
(stream, frame, bin) = (1, 2, 2) mesh of ``make_mesh3``. The ranks run
every case on their own streams and write their shards; the tests here
join the shards and hold them to the JAX package's own sharded functions
on a (2, 2) (or (1, 2, 2)) mesh of the conftest's virtual CPU devices, on
the same numpy inputs (tests/test_sharding.py's scenes on aira3, hop 64).
Bars:

* ``sharded_spectral_pipeline`` on both meshes, the generic
  ``sharded_batched_step`` (dense MVDR and LCMV, GSS, phase, mcra,
  phasempf) and the dense autopad case, float64: 1e-10, outputs and state;
* the ``stream`` solver (MVDR, LCMV, autopad): float32, 2e-4 of each
  stream's peak and state within 1e-5, tests/test_sharding.py's budgets
  (the port's plain versions against the Pallas kernels in interpret
  mode);
* ``sharded_training_step``: float32, 1e-5;
* every rank of a bin group returns the same output, bit for bit.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.config import GssParams as JGssParams
from beamform_tpu.config import parse_array_config as jparse
from beamform_tpu.geometry import (ArrayGeometry, frequency_vector,
                                   steering_delays, steering_weights)
from beamform_tpu.models import get_model as jget_model
from beamform_tpu.parallel import mesh as jmesh
from beamform_tpu.parallel import sharded as jsharded
from beamform_tpu_torch.parallel import mesh as tmesh
from beamform_tpu_torch.parallel.multihost import init_multihost

from conftest import AIRA3, make_scene
import torch_parallel_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP, FS = worker.HOP, worker.FS
WORLD, LOCAL = 4, 2
RANK_TIMEOUT_S = 240


def _jax_mesh3():
    return jmesh.make_mesh3(4, devices=jax.devices("cpu")[:4])


def _jax_mesh():
    return jmesh.make_mesh(devices=jax.devices("cpu")[:4], shape=(2, 2))


def _das_weights(theta):
    freqs = frequency_vector(2 * HOP, FS)
    tau = steering_delays(ArrayGeometry.from_xy(AIRA3), theta,
                          dtype=np.float64)
    return np.asarray(steering_weights(freqs, tau))


def _inputs():
    """tests/test_sharding.py's scenes, one set per case."""
    seeds = {"mvdr_dense": 30, "lcmv_dense": 30, "gss": 30,
             "phase": 50, "mcra": 50, "phasempf": 50, "mvdr_stream": 40,
             "lcmv_stream": 40, "autopad_dense": 50, "autopad_stream": 50}
    data = {"das/w": _das_weights(20.0),
            "train/w": _das_weights(0.0).astype(np.complex64)}
    data["das2/x"] = np.stack([make_scene(AIRA3, seconds=0.05,
                                          theta_deg=10.0 + 5 * i, seed=i,
                                          hop=HOP) for i in range(4)])
    data["das3/x"] = data["das2/x"][:2]
    data["train/x"] = np.stack([
        make_scene(AIRA3, seconds=0.05, seed=i, hop=HOP)
        for i in range(2)]).astype(np.float32)
    for case, (node, dtype, _) in worker.CASES.items():
        quiet = 0 if node in ("phase", "mcra", "phasempf") else 8
        xs = np.stack([make_scene(AIRA3, seconds=0.08, theta_deg=5.0 + 7 * i,
                                  seed=seeds[case] + i, hop=HOP,
                                  quiet_hops=quiet) for i in range(2)])
        data[f"{case}/x"] = xs.astype(np.float32 if dtype == "float32"
                                      else np.float64)
    return data


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the four ranks once; their npz files, by rank, and the
    inputs."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    data = _inputs()
    np.savez(tmp / "inputs.npz", **data)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(WORLD), LOCAL_WORLD_SIZE=str(LOCAL),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT)
    script = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, script, str(tmp / "inputs.npz"), str(tmp)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r % LOCAL)))
        for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    print(f"gloo world of {WORLD} ranks: {time.perf_counter() - t0:.1f} s")
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, data


def _rank_of(ranks, stream, bin_):
    return next(r for r in ranks
                if tuple(r["coord"]) == (stream, bin_))


def _outputs(ranks, key):
    """The global (B, S) output: each stream group's rows, after checking
    that both ranks of the group returned them bit for bit."""
    rows = []
    for g in range(2):
        a, b = (_rank_of(ranks, g, k)[key] for k in range(2))
        np.testing.assert_array_equal(a, b, err_msg=f"{key}: bin group {g}")
        rows.append(a)
    return np.concatenate(rows)


def _state(ranks, key):
    """The global state's leaves, joined from the four shards."""
    leaves = []
    i = 0
    while f"{key}/state{i}" in ranks[0]:
        dim = int(ranks[0][f"{key}/bin_dim{i}"])
        rows = []
        for g in range(2):
            parts = [_rank_of(ranks, g, k)[f"{key}/state{i}"]
                     for k in range(2)]
            if dim < 0:
                np.testing.assert_array_equal(parts[0], parts[1])
                rows.append(parts[0])
            else:
                rows.append(np.concatenate(parts, axis=dim))
        leaves.append(np.concatenate(rows))
        i += 1
    return leaves


def _jax_step(case, x, state=None):
    node, dtype, params = worker.CASES[case]
    engine = JEngine(sample_rate=FS, window_size=HOP, dtype=dtype)
    cfg = jparse({f"mic{i}": {"id": i, "x": x_, "y": y}
                  for i, (x_, y) in enumerate(AIRA3)})
    model = jget_model(node, engine, cfg, params)
    mesh = _jax_mesh()
    if state is None:
        state = jsharded.sharded_state_init(mesh, model, 2)
    out, new = jsharded.sharded_batched_step(mesh, model, x, worker.THETAS,
                                             state)
    return np.asarray(out), new


def _peak_rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def test_mesh_shape_for_is_the_jax_packages():
    for n in range(1, 17):
        assert tmesh.mesh_shape_for(n) == jmesh.mesh_shape_for(n), n


@pytest.mark.parametrize("mesh", ["2axis", "3axis"])
def test_sharded_spectral_pipeline_matches_jax(world, mesh):
    ranks, data = world
    engine = JEngine(sample_rate=FS, window_size=HOP, dtype="float64")
    if mesh == "2axis":
        got = _outputs(ranks, "das2/out")
        want = jsharded.sharded_spectral_pipeline(_jax_mesh(), engine,
                                                  data["das/w"],
                                                  data["das2/x"])
    else:
        # (1, 2, 2): every rank holds both streams, its frames, its bins
        outs = [r["das3/out"] for r in ranks]
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])
        got = outs[0]
        assert sorted(tuple(r["das3/coord"]) for r in ranks) == [
            (0, f, k) for f in range(2) for k in range(2)]
        want = jsharded.sharded_spectral_pipeline(_jax_mesh3(), engine,
                                                  data["das/w"],
                                                  data["das3/x"])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-10, rtol=0)


def _check_case(world, case, atol_out, atol_state, rel=False,
                jax_pads_mics=False):
    ranks, data = world
    x = data[f"{case}/x"]
    want_out, want_state = _jax_step(case, x)
    got = _outputs(ranks, f"{case}/out")
    if rel:
        for i in range(2):
            assert _peak_rel(got[i], want_out[i]) < atol_out, (case, i)
    else:
        np.testing.assert_allclose(got, want_out, atol=atol_out, rtol=0,
                                   err_msg=case)
    want_leaves = jax.tree.leaves(want_state)
    got_leaves = _state(ranks, case)
    assert len(got_leaves) == len(want_leaves), case
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        if jax_pads_mics and g.shape != w.shape:
            # the JAX masking models name their mic pairs ``ib``, which
            # the JAX sharded layer takes for in-band bins: it zero-pads
            # the (B, M, hop) input tail's mic axis up to the bin axis
            assert g.shape[:1] + g.shape[2:] == w.shape[:1] + w.shape[2:]
            assert not w[:, g.shape[1]:].any(), case
            w = w[:, :g.shape[1]]
        assert g.shape == w.shape, (case, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=atol_state, rtol=0,
                                   err_msg=case)
    return got, want_state


@pytest.mark.parametrize("case", ["mvdr_dense", "lcmv_dense", "gss"])
def test_sharded_stateful_model_matches_jax(world, case):
    """The models' own batched step over (stream, bin): outputs and the
    joined state shards equal the JAX package's sharded run, and the
    per-bin state is really split over the bin axis."""
    _check_case(world, case, 1e-10, 1e-10)
    ranks, _ = world
    dims = [int(ranks[0][k]) for k in ranks[0] if
            k.startswith(f"{case}/bin_dim")]
    assert any(d > 0 for d in dims), case


@pytest.mark.parametrize("case", ["phase", "mcra", "phasempf"])
def test_sharded_masking_family_matches_jax(world, case):
    """Streams over the mesh; the masks keep no per-bin state, so nothing
    is bin-sharded (the port's masking models have no band)."""
    _check_case(world, case, 1e-10, 1e-10, jax_pads_mics=True)


@pytest.mark.parametrize("case", ["mvdr_stream", "lcmv_stream"])
def test_sharded_stream_solver_matches_jax(world, case):
    """The stream solve kernel's plain version on each rank's bin group
    (one call a rank), one all-gather, against the JAX package's Pallas
    kernel under shard_map in interpret mode."""
    _check_case(world, case, 2e-4, 1e-5, rel=True)


@pytest.mark.parametrize("case,tol", [("autopad_dense", 1e-10),
                                      ("autopad_stream", 2e-4)])
def test_sharded_indivisible_bins_autopad(world, case, tol):
    """41 in-band bins on a 2-way bin axis: the state pads to 42 and is
    still bin-sharded; outputs match the JAX package's, and the padded
    state feeds a second chunk."""
    ranks, data = world
    _, want_state = _check_case(world, case, tol, 1e-10 if tol < 1e-9
                                else 1e-5, rel=True)
    init = _state(ranks, f"{case}/init")
    assert init[-1].shape[-1] == 42
    assert ranks[0][f"{case}/state{len(init) - 1}"].shape[-1] == 21
    want2, _ = _jax_step(case, data[f"{case}/x"], want_state)
    got2 = _outputs(ranks, f"{case}/out2")
    assert np.isfinite(got2).all()
    for i in range(2):
        assert _peak_rel(got2[i], want2[i]) < tol, (case, i)


def test_sharded_training_step_matches_jax(world):
    ranks, data = world
    engine = JEngine(sample_rate=FS, window_size=HOP, dtype="float32")
    mesh = _jax_mesh()
    w = data["train/w"]
    state = jsharded.make_training_state(mesh, engine, 2, 3, 2, w)
    out, new, power = jsharded.sharded_training_step(
        mesh, engine, JGssParams(freq_mag_threshold=1e-6, mu=0.001),
        data["train/x"], w, state)
    init = np.concatenate([np.concatenate(
        [_rank_of(ranks, g, k)["train/init"] for k in range(2)], axis=1)
        for g in range(2)])
    np.testing.assert_array_equal(init, np.asarray(state))
    got = np.concatenate([np.concatenate(
        [_rank_of(ranks, g, k)["train/state"] for k in range(2)], axis=1)
        for g in range(2)])
    assert np.abs(got - init).max() > 0          # it learned
    np.testing.assert_allclose(got, np.asarray(new), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_outputs(ranks, "train/out"),
                               np.asarray(out), atol=1e-5, rtol=0)
    for r in ranks:
        np.testing.assert_allclose(r["train/power"], float(power),
                                   rtol=1e-5)


def test_multi_node_world_keeps_bins_in_a_node(world):
    """Four ranks on two nodes of two: only ``stream`` spans the nodes,
    each rank's streams are placed on it with their global offset, and
    the sharded GSS chunk equals the single-process run of each stream
    (the port's counterpart of tests/test_multihost.py's two-process
    smoke test)."""
    ranks, data = world
    np.testing.assert_array_equal(ranks[0]["mesh"], [[0, 1], [2, 3]])
    for r in ranks:
        assert r["report"].tolist() == [2, 1]
        g = int(r["coord"][0])
        assert r["das2/placed"].tolist() == [4, 2 * g]
        np.testing.assert_array_equal(r["das2/x"],
                                      data["das2/x"][2 * g:2 * g + 2])
        np.testing.assert_allclose(r["gss/out"], r["gss/single"],
                                   atol=1e-10, rtol=0)


def test_init_multihost_is_a_noop_without_configuration(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert init_multihost() is False


def test_make_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.make_mesh()
