"""The port's batched multi-stream serving (``runtime/batch.BatchRunner``
and the models' batching protocol) against the JAX package's and against
the port's own single-stream runs, on the CPU.

Inputs are numpy scenes from a seed on aira3 at hop 128 (0.1 s, three
streams steered at 5, -20 and 40 degrees), as tests/test_batch.py builds
them. On the CPU the port runs its kernels' plain versions; ``solver``
variants drive the plain versions of the stream-axis kernels (rows 3-6:
``mvdr_stream``, ``lcmv_stream``, ``mega_stream``, ``gss_mega``; rows 7
and 8 and the MCRA march: ``phase_mask``, ``mpf_march``, ``mcra_march``)
and MVDR's ``dense`` block pipeline over a stream axis. Bars:

* float64, the port's BatchRunner against the JAX BatchRunner, and each
  stream against the port's single-stream ``process``: 1e-10 (the bar of
  tests/test_batch.py);
* float32 ``solver="mega"`` against the JAX float32 runner with its Pallas
  kernel in interpret mode: 2e-4 of peak, the bar tests/test_torch_mega.py
  holds the port's float32 ``mega`` to the JAX model's at (its 1e-6 bar is
  for float64 through a float32 WAV); each stream against the port's own
  float32 single-stream run: 1e-7, the bar of the JAX package's
  test_batch_vmaps_the_mega_kernel;
* float32 ``solver="fused"`` phase and phasempf: each stream against the
  port's own float32 single-stream run bit for bit, and against the JAX
  float32 runner (its Pallas kernel in interpret mode) under the JAX
  package's mask contract, tests/test_phase_mask.py
  ``assert_close_mod_flips``;
* the plain versions with a stream axis against the old per-stream plain
  version: bit for bit.
"""

import ast
import functools
import inspect
import pathlib

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.config import parse_array_config as jparse
from beamform_tpu.runtime.batch import BatchRunner as JBatchRunner
from beamform_tpu_torch.config import (EngineConfig, load_launch_params,
                                       parse_array_config)
from beamform_tpu_torch.convert import state_from_jax
from beamform_tpu_torch.kernels import gss_stream as tgss
from beamform_tpu_torch.kernels import lcmv_stream as tlcmv
from beamform_tpu_torch.kernels import mega_stream as tmega
from beamform_tpu_torch.kernels import mvdr_stream as tmvdr
from beamform_tpu_torch.kernels import phase_mask as tpm
from beamform_tpu_torch.kernels import wola as twola
from beamform_tpu_torch import models as models_pkg
from beamform_tpu_torch.models import get_model
from beamform_tpu_torch.models.batching import (BatchableModel,
                                                stack_states)
from beamform_tpu_torch.parallel import sharded as sharded_mod
from beamform_tpu_torch.runtime import batch as batch_mod
from beamform_tpu_torch.runtime.batch import BatchRunner
from beamform_tpu_torch.runtime.timeline import static_interference

from conftest import AIRA3, make_scene
from test_phase_mask import assert_close_mod_flips

HOP = 128
B = 3
THETAS = np.array([5.0, -20.0, 40.0])
GATED = dict(past_windows=6, freq_mag_threshold=0.0008, freq_max=16000.0,
             freq_min=100.0)
# the ten nodes under tests/test_batch.py's parameters; phase, phasempf,
# ref and read under their launch presets
NODES = {
    "das": {},
    "mcra": dict(L=10),
    "gss": dict(freq_mag_threshold=0.0008, freq_max=16000.0, freq_min=100.0,
                mu=0.001),
    "gsc": dict(mu0=0.0001, mu_max=0.1, filter_size=16),
    "mvdr": GATED,
    "lcmv": GATED,
    "phase": load_launch_params("phase"),
    "phasempf": load_launch_params("phasempf"),
    "ref": load_launch_params("ref"),
    "read": load_launch_params("read"),
}
# the batched paths of the stream-axis kernels' plain versions
VARIANTS = {
    "mvdr-stream": ("mvdr", dict(GATED, solver="stream")),
    "mvdr-mega": ("mvdr", dict(GATED, solver="mega")),
    "lcmv-stream": ("lcmv", dict(GATED, solver="stream")),
    "lcmv-mega": ("lcmv", dict(GATED, solver="mega")),
    "gss-mega": ("gss", dict(NODES["gss"], solver="mega")),
    "mvdr-dense": ("mvdr", dict(GATED, solver="dense")),
    "lcmv-dense": ("lcmv", dict(GATED, solver="dense")),
}
CASES = {**{k: (k, v) for k, v in NODES.items()}, **VARIANTS}


def _cfg(interf=()):
    doc = {f"mic{i}": {"id": i, "x": x, "y": y}
           for i, (x, y) in enumerate(AIRA3)}
    if interf:
        doc["interference"] = list(interf)
    return doc


def _engines(dtype):
    kw = dict(sample_rate=48000, window_size=HOP, dtype=dtype)
    return JEngine(**kw), EngineConfig(**kw)


@functools.lru_cache(maxsize=None)
def _scenes(seed0=10):
    """(B, 3, S) scenes with a quiet lead-in that keeps MVDR/LCMV cold
    covariances below the energy gate."""
    return np.stack([make_scene(AIRA3, seconds=0.1, theta_deg=10.0 + 7 * i,
                                seed=seed0 + i, hop=HOP, quiet_hops=8)
                     for i in range(B)])


@functools.lru_cache(maxsize=None)
def _port_batched(case):
    name, params = CASES[case]
    runner = BatchRunner(name, _engines("float64")[1],
                         parse_array_config(_cfg()), params, batch=B,
                         device="cpu")
    return runner.process(_scenes(), THETAS).numpy()


@pytest.mark.parametrize("name", list(NODES))
def test_batch_runner_matches_jax(name):
    """The port's BatchRunner equals the JAX package's, float64."""
    jeng, _ = _engines("float64")
    jr = JBatchRunner(name, jeng, jparse(_cfg()), NODES[name], batch=B)
    ref = np.asarray(jr.process(_scenes(), THETAS))
    got = _port_batched(name)
    assert got.shape == ref.shape and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_batch_matches_single_stream(case):
    """Each stream of a batched call equals the port's single-stream run."""
    name, params = CASES[case]
    model = get_model(name, _engines("float64")[1],
                      parse_array_config(_cfg()), params, device="cpu")
    got = _port_batched(case)
    for i in range(B):
        yi = model.process(_scenes()[i], float(THETAS[i])).numpy()
        np.testing.assert_allclose(got[i], yi, rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_single_stream_is_the_batch_of_one(case, monkeypatch):
    """A stream's ``process_chunk`` is one call of the model's
    ``batched_forward`` on a batch of one (the chunk and every state leaf
    with a leading axis of one), and its output and state are
    ``BatchRunner(batch=1)``'s bit for bit."""
    name, params = CASES[case]
    teng = _engines("float64")[1]
    cfg = parse_array_config(_cfg())
    model = get_model(name, teng, cfg, params, device="cpu")
    real, calls = model.batched_forward, []

    def spy(x, ctrl, state, **kw):
        calls.append((tuple(x.shape),
                      {leaf.shape[0] for leaf in pytree.tree_leaves(state)}))
        return real(x, ctrl, state, **kw)

    monkeypatch.setattr(model, "batched_forward", spy)
    x = _scenes()[0]
    x = x[:, :x.shape[-1] // HOP * HOP]
    out, state = model.process_chunk(x, float(THETAS[0]),
                                     model.stream_init())
    assert calls == [((1,) + x.shape, {1})]
    runner = BatchRunner(name, teng, cfg, params, batch=1, device="cpu")
    ref = runner.process(x[None], THETAS[:1])
    assert out.shape == ref[0].shape and torch.equal(out, ref[0])
    for got, want in zip(pytree.tree_leaves(state),
                         pytree.tree_leaves(runner.state)):
        np.testing.assert_array_equal(got.numpy(), want[0].numpy())


def test_each_model_has_one_forward_path():
    """No module of ``models/`` defines a second forward, a second control
    builder or the single-stream WOLA helpers; the protocol keeps no
    per-stream default; the mesh layer asks the model, not its name."""
    gone = {"_forward", "_gated_forward_batched", "_theta_ctrl",
            "_interf_ctrl", "_steering", "aligned_streams", "stft_ext_carry",
            "stft_ext_carry_mag", "istft_ext_carry"}
    for path in pathlib.Path(models_pkg.__file__).parent.glob("*.py"):
        defined = {node.name for node in ast.walk(ast.parse(path.read_text()))
                   if isinstance(node, ast.FunctionDef)}
        assert not defined & gone, (path.name, defined & gone)
    assert "batched_forward" not in vars(BatchableModel)
    assert not hasattr(BatchableModel, "batch_axes")
    src = inspect.getsource(sharded_mod)
    assert "model.name" not in src
    for private in ("._steering_ib", "._strategy", "._gated_forward"):
        assert private not in src


@pytest.mark.parametrize("case", ["das", "mvdr-stream", "lcmv-mega",
                                  "gss-mega", "gsc", "mcra", "phasempf",
                                  "read", "mvdr-dense"])
def test_batch_state_carries_across_chunks(case):
    """Two half chunks equal one whole call; the JAX runner's state after
    chunk 1, converted, gives the JAX runner's chunk 2 on the port."""
    name, params = CASES[case]
    jeng, teng = _engines("float64")
    xs = _scenes(20)
    half = xs.shape[-1] // (2 * HOP) * HOP
    runner = BatchRunner(name, teng, parse_array_config(_cfg()), params,
                         batch=B, device="cpu")
    y1 = runner.process(xs[:, :, :half], THETAS).numpy()
    y2 = runner.process(xs[:, :, half:], THETAS).numpy()
    whole = _port_batched_on(case, xs)
    np.testing.assert_allclose(np.concatenate([y1, y2], axis=1), whole,
                               rtol=0, atol=1e-10)

    jparams = {k: v for k, v in params.items() if k != "solver"}
    jr = JBatchRunner(name, jeng, jparse(_cfg()), jparams, batch=B)
    jr.process(xs[:, :, :half], THETAS)
    import jax
    leaves = [np.asarray(a) for a in jax.tree.leaves(jr.state)]
    ref2 = np.asarray(jr.process(xs[:, :, half:], THETAS))
    resumed = BatchRunner(name, teng, parse_array_config(_cfg()), params,
                          batch=B, device="cpu")
    resumed.state = state_from_jax(
        leaves, like=resumed.model.batched_state_init(B))
    got2 = resumed.process(xs[:, :, half:], THETAS).numpy()
    np.testing.assert_allclose(got2, ref2, rtol=0, atol=1e-10)


def _port_batched_on(case, xs):
    name, params = CASES[case]
    runner = BatchRunner(name, _engines("float64")[1],
                         parse_array_config(_cfg()), params, batch=B,
                         device="cpu")
    return runner.process(xs, THETAS).numpy()


@pytest.mark.parametrize("name", ["mvdr", "lcmv"])
def test_batch_mega_float32_matches_jax(name):
    """float32 ``solver="mega"``, batched, against the JAX float32 runner
    (its fused Pallas kernel in interpret mode), within 2e-4 of peak, and
    against the port's float32 single-stream run within 1e-7."""
    jeng, teng = _engines("float32")
    params = dict(GATED, solver="mega")
    xs = np.stack([make_scene(AIRA3, seconds=0.1, theta_deg=10.0 + 7 * i,
                              seed=30 + i, hop=HOP, quiet_hops=6)
                   for i in range(2)])
    th = THETAS[:2]
    ref = np.asarray(JBatchRunner(name, jeng, jparse(_cfg()), params,
                                  batch=2).process(xs, th))
    got = BatchRunner(name, teng, parse_array_config(_cfg()), params,
                      batch=2, device="cpu").process(xs, th).numpy()
    peak = np.abs(ref).max()
    assert peak > 0.01
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4 * peak)
    model = get_model(name, teng, parse_array_config(_cfg()), params,
                      device="cpu")
    for i in range(2):
        np.testing.assert_allclose(
            got[i], model.process(xs[i], float(th[i])).numpy(), rtol=0,
            atol=1e-7)


@pytest.mark.parametrize("name", ["das", "mvdr", "gsc"])
def test_theta_forms(name):
    """A scalar, a (B,) array and a (B, T) timeline: a constant timeline
    gives the (B,) form's output bit for bit (DAS and GSC broadcast one
    steering a stream, MVDR gathers per frame), and a timeline that
    changes mid-chunk equals each stream's single-stream run."""
    params = NODES[name]
    _, teng = _engines("float64")
    cfg = parse_array_config(_cfg())
    xs = _scenes()
    t = xs.shape[-1] // HOP

    def run(theta):
        return BatchRunner(name, teng, cfg, params, batch=B,
                           device="cpu").process(xs, theta).numpy()

    per_stream = run(THETAS)
    np.testing.assert_array_equal(run(np.repeat(THETAS[:, None], t, 1)),
                                  per_stream)
    np.testing.assert_array_equal(run(12.0), run(np.full(B, 12.0)))
    tl = np.repeat(THETAS[:, None], t, 1)
    tl[:, t // 2:] += np.array([10.0, -5.0, 0.0])[:, None]
    got = run(tl)
    model = get_model(name, teng, cfg, params, device="cpu")
    for i in range(B):
        np.testing.assert_allclose(got[i], model.process(xs[i], tl[i]),
                                   rtol=0, atol=1e-10)
    # the gather path itself, on the collapsing models
    if model.collapse_constant_steering:
        uniq, idx = model.batch_controls(np.repeat(THETAS[:, None], t, 1))
        assert idx.shape == (B, 1)
        state = model.batched_state_init(B)
        x = torch.as_tensor(xs)
        bcast, _ = model.batched_forward(x, (uniq, idx), state)
        gathered, _ = model.batched_forward(x, (uniq, idx.expand(B, t)),
                                            state)
        np.testing.assert_array_equal(bcast.numpy(), gathered.numpy())


@pytest.mark.parametrize("name", ["lcmv", "gss"])
def test_constrained_batch_refuses_an_interference_timeline(name):
    """Batched serving shares one static interference set, with the JAX
    package's message."""
    model = get_model(name, _engines("float64")[1],
                      parse_array_config(_cfg(interf=[-60.0])),
                      NODES[name], device="cpu")
    tl = static_interference(4, [-60.0])
    with pytest.raises(ValueError, match="batched serving shares one static "
                       "interference set; replay per-stream event "
                       "timelines through per-stream sessions"):
        model.batch_controls(np.zeros((B, 4)), interference=tl)
    with pytest.raises(ValueError, match="takes no interference timeline"):
        get_model("mvdr", _engines("float64")[1], parse_array_config(_cfg()),
                  GATED, device="cpu").batch_controls(np.zeros((B, 4)),
                                                      interference=tl)


def test_batch_runner_refuses_the_wrong_batch():
    runner = BatchRunner("das", _engines("float64")[1],
                         parse_array_config(_cfg()), batch=B, device="cpu")
    with pytest.raises(ValueError, match="B=3"):
        runner.process(_scenes()[:2], THETAS[:2])


def test_batch_runner_uses_only_the_declared_protocol():
    """BatchRunner reaches into no model private and switches on no model
    name (tests/test_batch.py's rule)."""
    src = inspect.getsource(batch_mod)
    assert "._forward" not in src
    assert "model.name" not in src


@pytest.mark.parametrize("name,interf", [("lcmv", [-60.0, 70.0]),
                                         ("gss", [-60.0])])
def test_constrained_batch_with_static_interferers(name, interf):
    """The shared static interference set: each stream equals its
    single-stream run, and the JAX runner's output."""
    jeng, teng = _engines("float64")
    params = NODES[name]
    got = BatchRunner(name, teng, parse_array_config(_cfg(interf)), params,
                      batch=B, device="cpu").process(_scenes(),
                                                     THETAS).numpy()
    ref = np.asarray(JBatchRunner(name, jeng, jparse(_cfg(interf)), params,
                                  batch=B).process(_scenes(), THETAS))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    model = get_model(name, teng, parse_array_config(_cfg(interf)), params,
                      device="cpu")
    for i in range(B):
        np.testing.assert_allclose(
            got[i], model.process(_scenes()[i], float(THETAS[i])).numpy(),
            rtol=0, atol=1e-10)


# ------------------------------------------------ plain versions, rows 3-6


def _stream_operands(rng, b=3, t=9, m=4, nb=18, w=3, u=2, s=2):
    def c(*shape):
        return torch.complex(torch.as_tensor(rng.standard_normal(shape)),
                             torch.as_tensor(rng.standard_normal(shape)))
    ib = torch.arange(2, 12)
    nib = len(ib)
    return dict(x=c(t, b, m, nb), hist=c(b, w, m, nib), d=c(u, m, nib),
                c=c(u, s, m, nib),
                idx=torch.as_tensor(rng.integers(0, u, (b, t))),
                gate=torch.as_tensor(rng.random((b, t, nib)) > 0.3), ib=ib)


def _mask_operands(rng, b=3, t=9, m=4, nb=18, u=2):
    """Rows 7 and 8 and the MCRA march with a stream axis: spectra (T, B,
    M, NB) of a source steered by one of ``u`` rows under noise that rises
    over the bins (so both masks' gates open and close), the steering,
    each (stream, frame)'s row, and states whose current_l differ per
    stream (one rolls over at the second frame under L = 3)."""
    w = torch.as_tensor(np.exp(1j * rng.uniform(-np.pi, np.pi, (u, m, nb))))
    idx = torch.as_tensor(rng.integers(0, u, (b, t)))
    src = rng.standard_normal((t, b, 1, nb)) + 1j * rng.standard_normal(
        (t, b, 1, nb))
    noise = (rng.standard_normal((t, b, m, nb))
             + 1j * rng.standard_normal((t, b, m, nb)))
    spec = torch.as_tensor(src * w.numpy()[idx.numpy().T]
                           + noise * np.linspace(0.01, 2.0, nb))
    cur = [0, 2, 4][:b]
    states = {cls: [tpm.init_state(cls, nb, torch.float64)._replace(
        current_l=torch.tensor(c, dtype=torch.int32)) for c in cur]
        for cls in (tpm.MpfState, tpm.McraState)}
    return spec, w, idx, states


def _mask_row(row, spec, w, idx, states):
    """(the row's plain version on B streams, on each stream alone): each
    (output, state) or output."""
    from beamform_tpu_torch.config import McraParams, PhasempfParams
    b = spec.shape[1]
    if row == "phase_mask":
        args = (0.6, 0.001, 0.1, 32)
        return (tpm.phase_mask_plain(spec, w, idx, *args),
                [tpm.phase_mask_plain(spec[:, i].contiguous(), w, idx[i],
                                      *args) for i in range(b)])
    if row == "mpf_march":
        p = PhasempfParams(**dict(NODES["phasempf"], MCRA_L=3))
        sts = states[tpm.MpfState]
        return (tpm.mpf_march_plain(spec, w, idx, stack_states(sts), p,
                                    True),
                [tpm.mpf_march_plain(spec[:, i].contiguous(), w, idx[i],
                                     sts[i], p, True) for i in range(b)])
    p = McraParams(L=3)
    x = spec[:, :, 0]
    sq = x.abs() ** 2
    s_f = sq * 0.75
    sts = states[tpm.McraState]
    return (tpm.mcra_march_plain(s_f, sq, x, stack_states(sts), p, False),
            [tpm.mcra_march_plain(s_f[:, i].contiguous(),
                                  sq[:, i].contiguous(), x[:, i].contiguous(),
                                  sts[i], p, False) for i in range(b)])


@pytest.mark.parametrize("row", ["mvdr_stream", "lcmv_stream", "phase_mask",
                                 "mpf_march", "mcra_march"])
def test_stream_axis_plain_equals_per_stream(row):
    """Rows 3, 5, 7 and 8 and the MCRA march: the plain version with a
    stream axis is the old plain version per stream, stacked, bit for bit
    (the marches' states too, current_l differing per stream)."""
    if row in ("phase_mask", "mpf_march", "mcra_march"):
        got, refs = _mask_row(row, *_mask_operands(
            np.random.default_rng(6)))
        for i, ref in enumerate(refs):
            if row == "phase_mask":
                assert got.shape == (3, 9, 18)
                assert torch.equal(got[i], ref)
                continue
            assert got[0].shape == (3, 9, 18)
            assert torch.equal(got[0][i], ref[0])
            assert got[1].current_l.shape == (3,)
            for a, r in zip(got[1], ref[1]):
                assert torch.equal(a[i], r)
        if row == "mpf_march":
            assert got[1].current_l.tolist() != [got[1].current_l[0]] * 3
        return
    o = _stream_operands(np.random.default_rng(3))
    if row == "mvdr_stream":
        fn, ctrl = tmvdr.mvdr_stream, o["d"]
    else:
        fn, ctrl = tlcmv.lcmv_stream, o["c"]
    got = fn(o["x"], o["hist"], ctrl, o["idx"], o["gate"], o["ib"])
    assert got.shape == (3, 9, 10)
    for b in range(3):
        ref = fn(o["x"][:, b].contiguous(), o["hist"][b], ctrl, o["idx"][b],
                 o["gate"][b], o["ib"])
        assert torch.equal(got[b], ref)


@pytest.mark.parametrize("row", ["mega_stream", "gss_mega"])
def test_fused_stream_axis_plain_equals_per_stream(row):
    """Rows 4 and 6: the fused kernels' plain versions with a stream axis
    are the old plain version per stream, stacked, bit for bit."""
    rng = np.random.default_rng(4)
    b, m, hop, t, u = 3, 4, 128, 12, 2
    ib = torch.arange(3, 40)
    nib = len(ib)

    def c(*shape):
        return torch.complex(torch.as_tensor(rng.standard_normal(shape)),
                             torch.as_tensor(rng.standard_normal(shape)))

    x = torch.as_tensor(0.1 * rng.standard_normal((b, m, t * hop)))
    tail = torch.as_tensor(0.1 * rng.standard_normal((b, m, hop)))
    prev = torch.as_tensor(rng.standard_normal((b, hop)))
    idx = torch.as_tensor(rng.integers(0, u, (b, t)))
    if row == "mega_stream":
        hist = c(b, 3, m, nib)
        ctrl = c(u, 2, m, nib)
        got = tmega.lcmv_mega(x, tail, prev, hist, ctrl, idx, ib, 2 * hop, 3,
                              1e-4)
        refs = [tmega.lcmv_mega(x[i], tail[i], prev[i], hist[i], ctrl,
                                idx[i], ib, 2 * hop, 3, 1e-4)
                for i in range(b)]
    else:
        w0 = c(b, nib, 2, m)
        ah = c(u, 2, m, nib)
        reset = torch.as_tensor(rng.random((b, t)) > 0.7)
        got = tgss.gss_mega(x, tail, prev, w0, ah, idx, reset, ib, 2 * hop,
                            1e-4, 1e-3, 0.0)
        refs = [tgss.gss_mega(x[i], tail[i], prev[i], w0[i], ah, idx[i],
                              reset[i], ib, 2 * hop, 1e-4, 1e-3, 0.0)
                for i in range(b)]
    for i, ref in enumerate(refs):
        for g, r in zip(got, ref):
            assert torch.equal(g[i], r)


@pytest.mark.parametrize("name", ["phase", "phasempf"])
def test_batch_fused_float32(name):
    """float32 ``solver="fused"`` batched (one call of the mask kernels'
    plain version for the B streams): each stream equals the port's own
    float32 single-stream run bit for bit, and the JAX float32 runner with
    its Pallas kernel in interpret mode under the mask contract."""
    jeng, teng = _engines("float32")
    params = dict(NODES[name], solver="fused")
    got = BatchRunner(name, teng, parse_array_config(_cfg()), params,
                      batch=B, device="cpu").process(_scenes(), THETAS)
    model = get_model(name, teng, parse_array_config(_cfg()), params,
                      device="cpu")
    for i in range(B):
        assert torch.equal(got[i], model.process(_scenes()[i],
                                                 float(THETAS[i])))
    ref = np.asarray(JBatchRunner(name, jeng, jparse(_cfg()), params,
                                  batch=B).process(_scenes(), THETAS))
    assert np.abs(ref).max() > 0
    assert_close_mod_flips(got.numpy(), ref)


# the kernel wrapper each batched node path calls, by (case, float dtype,
# the module that imports it)
SPIED = {"phase-fused": ("phase", dict(NODES["phase"], solver="fused"),
                         "float32", "phase", "phase_mask"),
         "phasempf-fused": ("phasempf",
                            dict(NODES["phasempf"], solver="fused"),
                            "float32", "phasempf", "mpf_march"),
         "mcra": ("mcra", NODES["mcra"], "float64", "mcra", "mcra_march"),
         "mvdr-dense": ("mvdr", dict(GATED, solver="dense"), "float64",
                        "mvdr", "gj_inverse"),
         "lcmv-dense": ("lcmv", dict(GATED, solver="dense"), "float64",
                        "mvdr", "gj_inverse")}


@pytest.mark.parametrize("case", list(SPIED))
def test_batched_forward_calls_each_kernel_as_one_stream_does(case,
                                                              monkeypatch):
    """A batched chunk of B = 3 streams calls the node's kernel wrapper as
    often as B = 1 does (dense: a Gauss-Jordan call a block, two for
    LCMV), not B times as often."""
    import importlib
    name, params, dtype, module, fn = SPIED[case]
    mod = importlib.import_module(f"beamform_tpu_torch.models.{module}")
    calls = []
    real = getattr(mod, fn)

    def spy(*args, **kwargs):
        calls.append(fn)
        return real(*args, **kwargs)

    monkeypatch.setattr(mod, fn, spy)
    counts = []
    for b in (1, B):
        calls.clear()
        BatchRunner(name, _engines(dtype)[1], parse_array_config(_cfg()),
                    params, batch=b, device="cpu").process(_scenes()[:b],
                                                           THETAS[:b])
        counts.append(len(calls))
    assert counts[0] == counts[1] >= 1, counts


def test_analysis_gate_statistic_per_stream():
    """Row 1's gate statistic with ``streams``: each stream's own."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((3 * 5, 6 * 128)))
    tail = torch.as_tensor(rng.standard_normal((3 * 5, 128)))
    spec, mag, _ = twola.wola_analysis(x, tail, with_mag=True, streams=3)
    assert mag.shape == (6, 3, 130)
    for b in range(3):
        _, ref, _ = twola.wola_analysis(x[5 * b:5 * b + 5],
                                        tail[5 * b:5 * b + 5], with_mag=True)
        torch.testing.assert_close(mag[:, b], ref, rtol=0, atol=1e-15)
