"""The port's CUDA kernels against their plain-torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs on a machine that has only the port's dependencies;
there, skip the JAX-based tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from beamform_tpu_torch import run_offline
from beamform_tpu_torch.config import (EngineConfig, load_array_config,
                                       load_launch_params)
from beamform_tpu_torch.kernels import lcmv_stream as klc
from beamform_tpu_torch.kernels import linalg as kl
from beamform_tpu_torch.kernels import mvdr_stream as km
from beamform_tpu_torch.kernels import wola as kw
from beamform_tpu_torch.models import get_model
from beamform_tpu_torch.runtime.streaming import StreamingSession
from beamform_tpu_torch.runtime.timeline import (InterfEvent,
                                                 replay_interference_events)

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5      # float32 kernel vs float32 torch.fft: sums in another order
# float32 MVDR solves of random covariances with W < M, conditioned only by
# the 1.001 loading: each float32 result carries 1e-4 of round-off or more
# (more at 32 mics), so the kernel is held to no more than twice the plain
# float32 version's error against float64, and to 1e-3 of the plain version
MVDR_REL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("hop", [128, 1024, 2048])
@pytest.mark.parametrize("with_mag", [False, True])
def test_analysis_kernel_matches_plain(cuda, hop, with_mag):
    rng = np.random.default_rng(hop)
    x = torch.as_tensor(rng.standard_normal((5, 7 * hop)),
                        dtype=torch.float32, device=cuda)
    tail = torch.as_tensor(rng.standard_normal((5, hop)),
                           dtype=torch.float32, device=cuda)
    before = kw.wola_analysis.launches
    spec, mag, new_tail = kw.wola_analysis(x, tail, with_mag)
    torch.cuda.synchronize()
    assert kw.wola_analysis.launches == before + 1
    ref_spec, ref_mag, ref_tail = kw.wola_analysis_plain(x, tail, with_mag)
    assert spec.shape == (7, 5, hop + 2) and spec.dtype == torch.complex64
    assert _rel(spec, ref_spec) < REL
    assert torch.equal(new_tail, ref_tail)
    if with_mag:
        assert _rel(mag, ref_mag) < REL


@pytest.mark.parametrize("hop", [128, 1024, 2048])
@pytest.mark.parametrize("c", [1, 5])
def test_synthesis_kernel_matches_plain(cuda, hop, c):
    rng = np.random.default_rng(hop + c)
    y = torch.complex(*(torch.as_tensor(rng.standard_normal((c, 9, hop + 2)),
                                        dtype=torch.float32)
                        for _ in range(2))).to(cuda)
    prev = torch.as_tensor(rng.standard_normal((c, hop)),
                           dtype=torch.float32, device=cuda)
    before = kw.wola_synthesis.launches
    out, new_prev = kw.wola_synthesis(y, prev)
    torch.cuda.synchronize()
    assert kw.wola_synthesis.launches == before + 1
    ref_out, ref_prev = kw.wola_synthesis_plain(y, prev)
    assert _rel(out, ref_out) < REL
    assert (new_prev - ref_prev).abs().max() / ref_out.abs().max() < REL


def test_unsupported_modes_raise_on_cuda(cuda):
    x = torch.zeros((2, 4 * 128), device=cuda)
    with pytest.raises(ValueError, match="ROADMAP"):
        kw.wola_analysis(x.double(), torch.zeros((2, 128), device=cuda,
                                                 dtype=torch.float64))
    with pytest.raises(ValueError, match="ROADMAP"):
        kw.wola_analysis(torch.zeros((2, 4 * 96), device=cuda),
                         torch.zeros((2, 96), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        kw.wola_analysis(torch.zeros((8 * 128, 2), device=cuda).T,
                         torch.zeros((2, 128), device=cuda))
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira3.yaml"))
    for eng in (EngineConfig(window_size=128, dtype="float64"),
                EngineConfig(window_size=128, full_fft=True)):
        with pytest.raises(ValueError, match="ROADMAP"):
            run_offline("das", np.zeros((3, 512)), engine=eng,
                        array_cfg=cfg, device="cuda")


def test_das_on_cuda_matches_float64_cpu(cuda):
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal((16, 40 * 1024))).astype(np.float32)
    th = np.full(40, 20.0)
    th[20:] = -35.0
    model = get_model("das", EngineConfig(), cfg, device=cuda)
    got = model.process(x, th).cpu().numpy()
    ref = run_offline("das", x, engine=EngineConfig(dtype="float64"),
                      array_cfg=cfg, theta=th, device="cpu")
    # BASELINE budget is 1e-3; float32 round-off here is ~1e-6
    assert np.abs(got - ref).max() <= 1e-5


def _cplx(rng, shape, device):
    return torch.complex(*(torch.as_tensor(rng.standard_normal(shape),
                                           dtype=torch.float32)
                           for _ in range(2))).to(device)


@pytest.mark.parametrize("m,nib,t,u", [(16, 37, 45, 1), (16, 37, 45, 3),
                                       (3, 9, 70, 2), (32, 11, 33, 1)])
@pytest.mark.parametrize("gate_kind", ["all", "random", "none"])
def test_mvdr_stream_kernel_matches_plain(cuda, m, nib, t, u, gate_kind):
    """Ragged bins and frames (not multiples of the 8 x 32 tile), several
    steerings, a band that is not contiguous, and gate patterns."""
    rng = np.random.default_rng(m * 100 + nib)
    w, nb = 10, 2 * nib + 5
    x = _cplx(rng, (t, m, nb), cuda)
    hist = _cplx(rng, (w, m, nib), cuda)
    d = _cplx(rng, (u, m, nib), cuda)
    ib = torch.as_tensor(np.sort(rng.choice(np.arange(1, nb), nib,
                                            replace=False)), device=cuda)
    w_idx = torch.as_tensor(rng.integers(0, u, t), device=cuda)
    gate = torch.as_tensor({"all": np.ones((t, nib), bool),
                            "none": np.zeros((t, nib), bool),
                            "random": rng.random((t, nib)) < 0.5}[gate_kind],
                           device=cuda)
    before = km.mvdr_stream.launches
    got = km.mvdr_stream(x, hist, d, w_idx, gate, ib)
    torch.cuda.synchronize()
    assert km.mvdr_stream.launches == before + 1
    ref = km.mvdr_stream_plain(x, hist, d, w_idx, gate, ib)
    f64 = km.mvdr_stream_plain(x.cdouble(), hist.cdouble(), d.cdouble(),
                               w_idx, gate, ib)
    assert got.shape == (t, nib) and got.dtype == torch.complex64
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert torch.equal(got[~gate], ref[~gate])      # 0.01 * x0, exactly
    if gate_kind != "none":
        assert _rel(got, ref) < MVDR_REL
        assert _rel(got.cdouble(), f64) <= max(2 * _rel(ref.cdouble(), f64),
                                               1e-6)


@pytest.mark.parametrize("m", [3, 16, 32])
@pytest.mark.parametrize("b", [1, 37, 1000])
@pytest.mark.parametrize("polish", [False, True])
def test_gj_inverse_kernel_matches_plain(cuda, m, b, polish):
    rng = np.random.default_rng(m + b)
    a = _cplx(rng, (b, m, m), cuda)
    a = (a @ a.conj().transpose(1, 2) / m
         + 0.5 * torch.eye(m, device=cuda)).contiguous()
    before = kl.gj_inverse.launches
    got = kl.gj_inverse(a, polish=polish)
    torch.cuda.synchronize()
    assert kl.gj_inverse.launches == before + 1
    ref = kl.gj_inverse_plain(a, polish=polish)
    assert got.shape == a.shape and _rel(got, ref) < REL
    eye = torch.eye(m, device=cuda, dtype=a.dtype)
    assert float((a @ got - eye).abs().max()) < 1e-4


def test_mvdr_kernels_raise_on_what_they_do_not_take(cuda):
    a = torch.eye(40, dtype=torch.complex64, device=cuda)[None]
    with pytest.raises(ValueError, match="M <= 32"):
        kl.gj_inverse(a)
    with pytest.raises(ValueError, match="ROADMAP"):
        kl.gj_inverse(a[:, :8, :8].to(torch.complex128).contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kl.gj_inverse(torch.eye(8, dtype=torch.complex64,
                                device=cuda)[None].transpose(1, 2)
                      .expand(2, 8, 8))
    t, m, nib = 4, 4, 3
    z = torch.zeros
    args = dict(x=z((t, m, nib), dtype=torch.complex64, device=cuda),
                hist=z((2, m, nib), dtype=torch.complex64, device=cuda),
                d=z((1, m, nib), dtype=torch.complex64, device=cuda),
                w_idx=z(t, dtype=torch.int64, device=cuda),
                gate=z((t, nib), dtype=torch.bool, device=cuda),
                ib=torch.arange(nib, device=cuda))
    with pytest.raises(ValueError, match="ROADMAP"):
        km.mvdr_stream(**dict(args, x=args["x"].cdouble()))
    with pytest.raises(ValueError, match="dtype"):
        km.mvdr_stream(**dict(args, w_idx=args["w_idx"].int()))
    with pytest.raises(ValueError, match="M <= 32"):
        km.mvdr_stream(**dict(args, x=z((t, 40, nib), dtype=torch.complex64,
                                         device=cuda)))


def test_mvdr_stream_index_out_of_range_gives_nan(cuda):
    """The kernel checks its index tensors on the card: an out-of-range bin
    poisons its own bin, an out-of-range steering its own frame's solves;
    everything else matches the plain version."""
    rng = np.random.default_rng(9)
    t, m, nib, w = 40, 16, 9, 10
    x = _cplx(rng, (t, m, 2 * nib), cuda)
    hist = _cplx(rng, (w, m, nib), cuda)
    d = _cplx(rng, (2, m, nib), cuda)
    ib = torch.arange(0, 2 * nib, 2, device=cuda)
    w_idx = torch.as_tensor(rng.integers(0, 2, t), device=cuda)
    gate = torch.ones((t, nib), dtype=torch.bool, device=cuda)
    gate[::3] = False
    ref = km.mvdr_stream_plain(x, hist, d, w_idx, gate, ib)
    for bad_ib, bad_w in ((-1, None), (2 * nib, None), (None, 2),
                          (None, -1)):
        ib2, w_idx2 = ib.clone(), w_idx.clone()
        if bad_ib is not None:
            ib2[4] = bad_ib
        if bad_w is not None:
            w_idx2[7] = bad_w
        got = km.mvdr_stream(x, hist, d, w_idx2, gate, ib2)
        nan = torch.zeros((t, nib), dtype=torch.bool, device=cuda)
        if bad_ib is not None:
            nan[:, 4] = True
        else:
            nan[7] = gate[7]
        assert torch.isnan(got[nan]).all()
        assert _rel(got[~nan], ref[~nan]) < MVDR_REL


@pytest.mark.parametrize("solver", ["auto", "dense"])
def test_mvdr_on_cuda_matches_float64_cpu(cuda, solver):
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    rng = np.random.default_rng(5)
    x = (0.1 * rng.standard_normal((16, 60 * 1024))).astype(np.float32)
    x[:, :12 * 1024] *= 1e-4                  # quiet lead-in > past_windows
    th = np.full(60, 20.0)
    th[35:] = -35.0
    params = dict(load_launch_params("mvdr"), solver=solver)
    before = (km.mvdr_stream.launches, kl.gj_inverse.launches)
    got = run_offline("mvdr", x, engine=EngineConfig(), array_cfg=cfg,
                      theta=th, params=params, device=cuda)
    ran = (km.mvdr_stream.launches - before[0],
           kl.gj_inverse.launches - before[1])
    assert ran == ((1, 0) if solver == "auto" else (0, 1))
    ref = run_offline("mvdr", x, engine=EngineConfig(dtype="float64"),
                      array_cfg=cfg, theta=th, params=params, device="cpu")
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-3      # BASELINE budget


def test_mvdr_stream_chunks_equal_offline_on_cuda(cuda):
    """Each window sum is recomputed from the frames it covers, so chunked
    output equals offline output bit for bit."""
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    rng = np.random.default_rng(6)
    x = (0.1 * rng.standard_normal((16, 48 * 1024))).astype(np.float32)
    x[:, :12 * 1024] *= 1e-4
    model = get_model("mvdr", EngineConfig(), cfg, load_launch_params("mvdr"),
                      device=cuda)
    offline = model.process(x, 20.0)
    sess = StreamingSession(model)
    chunks = [sess.process(x[:, i:i + 7 * 1024], 20.0)
              for i in range(0, x.shape[1], 7 * 1024)]
    assert torch.equal(torch.cat(chunks), offline)


# ------------------------------------------------------------------- LCMV


def _constraints(rng, u, s, m, nib, device):
    """Random constraint sets: row 0 with min(S, 3) active slots, row 1
    with min(S, 2) and the row-0 quirk (mic 0's row zero); the other slots
    inactive (zero columns)."""
    c = _cplx(rng, (u, s, m, nib), "cpu")
    c[0, 3:] = 0
    c[1, 2:] = 0
    c[1, :, 0] = 0
    return c.to(device)


@pytest.mark.parametrize("m", [3, 16, 32])
@pytest.mark.parametrize("s", [1, 3, 16])
def test_lcmv_stream_kernel_matches_plain(cuda, m, s):
    """Inactive slots, the row-0 quirk, two control rows, a band that is
    not contiguous, ragged tiles and a random gate."""
    rng = np.random.default_rng(m * 10 + s)
    t, nib, w, u = 45, 19, 10, 2
    nb = 2 * nib + 5
    x = _cplx(rng, (t, m, nb), cuda)
    hist = _cplx(rng, (w, m, nib), cuda)
    c = _constraints(rng, u, s, m, nib, cuda)
    ib = torch.as_tensor(np.sort(rng.choice(np.arange(1, nb), nib,
                                            replace=False)), device=cuda)
    idx = torch.as_tensor(rng.integers(0, u, t), device=cuda)
    gate = torch.as_tensor(rng.random((t, nib)) < 0.7, device=cuda)
    before = klc.lcmv_stream.launches
    got = klc.lcmv_stream(x, hist, c, idx, gate, ib)
    torch.cuda.synchronize()
    assert klc.lcmv_stream.launches == before + 1
    ref = klc.lcmv_stream_plain(x, hist, c, idx, gate, ib)
    f64 = klc.lcmv_stream_plain(x.cdouble(), hist.cdouble(), c.cdouble(),
                                idx, gate, ib)
    assert got.shape == (t, nib) and got.dtype == torch.complex64
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert torch.equal(got[~gate], ref[~gate])      # 0.01 * x0, exactly
    assert _rel(got, ref) < MVDR_REL
    assert _rel(got.cdouble(), f64) <= max(2 * _rel(ref.cdouble(), f64),
                                           1e-6)


def test_lcmv_stream_s1_equals_mvdr_stream(cuda):
    """With one constraint the LCMV solve is MVDR's w = R^-1 d / d^H R^-1 d,
    up to float32 round-off."""
    rng = np.random.default_rng(12)
    t, m, nib, w = 40, 16, 21, 10
    x = _cplx(rng, (t, m, nib), cuda)
    hist = _cplx(rng, (w, m, nib), cuda)
    d = _cplx(rng, (1, m, nib), cuda)
    ib = torch.arange(nib, device=cuda)
    idx = torch.zeros(t, dtype=torch.int64, device=cuda)
    gate = torch.ones((t, nib), dtype=torch.bool, device=cuda)
    got = klc.lcmv_stream(x, hist, d[:, None], idx, gate, ib)
    ref = km.mvdr_stream(x, hist, d, idx, gate, ib)
    assert _rel(got, ref) < MVDR_REL


def test_lcmv_stream_index_out_of_range_gives_nan(cuda):
    rng = np.random.default_rng(13)
    t, m, nib, w, s = 40, 16, 9, 10, 3
    x = _cplx(rng, (t, m, 2 * nib), cuda)
    hist = _cplx(rng, (w, m, nib), cuda)
    c = _constraints(rng, 2, s, m, nib, cuda)
    ib = torch.arange(0, 2 * nib, 2, device=cuda)
    idx = torch.as_tensor(rng.integers(0, 2, t), device=cuda)
    gate = torch.ones((t, nib), dtype=torch.bool, device=cuda)
    gate[::3] = False
    ref = klc.lcmv_stream_plain(x, hist, c, idx, gate, ib)
    for bad_ib, bad_u in ((-1, None), (2 * nib, None), (None, 2),
                          (None, -1)):
        ib2, idx2 = ib.clone(), idx.clone()
        if bad_ib is not None:
            ib2[4] = bad_ib
        if bad_u is not None:
            idx2[7] = bad_u
        got = klc.lcmv_stream(x, hist, c, idx2, gate, ib2)
        nan = torch.zeros((t, nib), dtype=torch.bool, device=cuda)
        if bad_ib is not None:
            nan[:, 4] = True
        else:
            nan[7] = gate[7]
        assert torch.isnan(got[nan]).all()
        assert _rel(got[~nan], ref[~nan]) < MVDR_REL


def test_lcmv_stream_raises_on_what_it_does_not_take(cuda):
    t, m, nib = 4, 4, 3
    z = torch.zeros
    args = dict(x=z((t, m, nib), dtype=torch.complex64, device=cuda),
                hist=z((2, m, nib), dtype=torch.complex64, device=cuda),
                c=z((1, 2, m, nib), dtype=torch.complex64, device=cuda),
                idx=z(t, dtype=torch.int64, device=cuda),
                gate=z((t, nib), dtype=torch.bool, device=cuda),
                ib=torch.arange(nib, device=cuda))
    with pytest.raises(ValueError, match="ROADMAP"):
        klc.lcmv_stream(**dict(args, c=args["c"].cdouble()))
    with pytest.raises(ValueError, match="dtype"):
        klc.lcmv_stream(**dict(args, idx=args["idx"].int()))
    with pytest.raises(ValueError, match="S <= 16"):
        klc.lcmv_stream(**dict(args, c=z((1, 17, m, nib),
                                         dtype=torch.complex64,
                                         device=cuda)))
    with pytest.raises(ValueError, match="M <= 32"):
        klc.lcmv_stream(**dict(args, x=z((t, 40, nib), dtype=torch.complex64,
                                         device=cuda)))


def _lcmv_scene(frames, seed):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((16, frames * 1024))).astype(np.float32)
    x[:, :12 * 1024] *= 1e-4                  # quiet lead-in > past_windows
    return x


@pytest.mark.parametrize("solver", ["auto", "dense"])
@pytest.mark.parametrize("scene", ["static", "events"])
def test_lcmv_on_cuda_matches_float64_cpu(cuda, solver, scene):
    """LCMV float32 on the card against the float64 CPU path, with each
    path's exact launches: one stream solve (auto), or two Gauss-Jordan
    inverses per dense block (R and the inner matrix)."""
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    x = _lcmv_scene(60, 5)
    t = 60
    interference = None
    if scene == "static":
        import dataclasses
        cfg = dataclasses.replace(cfg, interference_angles=(70.0, -60.0))
    else:
        interference = replay_interference_events(
            t, [70.0], [InterfEvent(25, 2, -60.0), InterfEvent(45, 2, 70.5)],
            threshold=1.0, capacity=15)
    params = dict(load_launch_params("lcmv"), solver=solver)
    model = get_model("lcmv", EngineConfig(), cfg, params, device=cuda)
    before = (klc.lcmv_stream.launches, km.mvdr_stream.launches,
              kl.gj_inverse.launches)
    got = model.process(x, 20.0, interference=interference).cpu().numpy()
    ran = (klc.lcmv_stream.launches - before[0],
           km.mvdr_stream.launches - before[1],
           kl.gj_inverse.launches - before[2])
    blocks = -(-t // model._block_frames(t))
    assert ran == ((1, 0, 0) if solver == "auto" else (0, 0, 2 * blocks))
    ref = run_offline("lcmv", x, engine=EngineConfig(dtype="float64"),
                      array_cfg=cfg, theta=20.0, params=params,
                      device="cpu", interference=interference)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-3      # BASELINE budget


def test_lcmv_stream_chunks_equal_offline_on_cuda(cuda):
    """Chunked LCMV with an interference timeline equals offline bit for
    bit, though each chunk trims its own unused slots."""
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    x = _lcmv_scene(49, 6)
    tl = replay_interference_events(
        49, [70.0], [InterfEvent(20, 2, -60.0), InterfEvent(33, 2, 70.5)],
        threshold=1.0, capacity=15)
    model = get_model("lcmv", EngineConfig(), cfg, load_launch_params("lcmv"),
                      device=cuda)
    offline = model.process(x, 20.0, interference=tl)
    sess = StreamingSession(model)
    chunks = []
    for f0 in range(0, 49, 7):
        rows = type(tl)(*(a[f0:f0 + 7] for a in (tl.angles, tl.active,
                                                 tl.row0, tl.reset)))
        chunks.append(sess.process(x[:, f0 * 1024:(f0 + 7) * 1024], 20.0,
                                   interference=rows))
    assert torch.equal(torch.cat(chunks), offline)
