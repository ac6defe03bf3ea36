"""The port's CUDA kernels against their plain-torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs on a machine that has only the port's dependencies;
there, skip the JAX-based tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from beamform_tpu_torch import run_offline
from beamform_tpu_torch.config import (EngineConfig, load_array_config,
                                       load_launch_params)
from beamform_tpu_torch.kernels import gss_stream as kgss
from beamform_tpu_torch.kernels import lcmv_stream as klc
from beamform_tpu_torch.kernels import linalg as kl
from beamform_tpu_torch.kernels import mega_stream as kmega
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


@pytest.mark.parametrize("hop", [128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("c", [1, 5, 16])
@pytest.mark.parametrize("t", [1, 7, 64])
@pytest.mark.parametrize("with_mag", [False, True])
def test_analysis_kernel_matches_plain(cuda, hop, c, t, with_mag):
    """Every nfft the kernel takes (each its own pass plan), odd and even
    channel counts (an odd last channel pairs with zeros; 16 channels are
    more pairs than a block holds at once), one frame to a streaming
    chunk, with and without the fused gate statistic: one launch."""
    rng = np.random.default_rng(hop + 10 * c + t)
    x = torch.as_tensor(rng.standard_normal((c, t * hop)),
                        dtype=torch.float32, device=cuda)
    tail = torch.as_tensor(rng.standard_normal((c, hop)),
                           dtype=torch.float32, device=cuda)
    before = kw.wola_analysis.launches
    spec, mag, new_tail = kw.wola_analysis(x, tail, with_mag)
    torch.cuda.synchronize()
    assert kw.wola_analysis.launches == before + 1
    ref_spec, ref_mag, ref_tail = kw.wola_analysis_plain(x, tail, with_mag)
    assert spec.shape == (t, c, hop + 2) and spec.dtype == torch.complex64
    assert _rel(spec, ref_spec) < REL
    assert torch.equal(new_tail, ref_tail)
    assert (mag is not None) == with_mag
    if with_mag:
        assert mag.shape == (t, hop + 2)
        assert _rel(mag, ref_mag) < REL


@pytest.mark.parametrize("hop", [128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("c", [1, 5, 16])
@pytest.mark.parametrize("t", [1, 2, 7, 1407])
def test_synthesis_kernel_matches_plain(cuda, hop, c, t):
    """Every nfft the kernel takes (256 on the full-length inverse, the
    others on the half-length one), one to sixteen channels, one frame, a
    block's first two, a ragged last block and a 30 s call: one launch."""
    rng = np.random.default_rng(hop + c + t)
    y = torch.complex(*(torch.as_tensor(rng.standard_normal((c, t, hop + 2)),
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


@pytest.mark.parametrize("c", [1, 16])
def test_synthesis_kernel_chunks_equal_one_call(cuda, c):
    """Blocks own whole hops and recompute the frame before them, so calls
    split at frames 1, 63, 64 and 700 (and 64-frame chunks) with the carry
    passed on equal one call of 1407 frames bit for bit."""
    rng = np.random.default_rng(c)
    t, hop = 1407, 1024
    y = torch.complex(*(torch.as_tensor(rng.standard_normal((c, t, hop + 2)),
                                        dtype=torch.float32)
                        for _ in range(2))).to(cuda)
    prev = torch.as_tensor(rng.standard_normal((c, hop)),
                           dtype=torch.float32, device=cuda)
    out, new_prev = kw.wola_synthesis(y, prev)
    for edges in ([0, 1, 63, 64, 700, t], list(range(0, t, 64)) + [t]):
        outs, p = [], prev
        for a, b in zip(edges[:-1], edges[1:]):
            o, p = kw.wola_synthesis(y[:, a:b].contiguous(), p)
            outs.append(o)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(outs, 1), out)
        assert torch.equal(p, new_prev)


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
    before = kw.wola_synthesis.launches
    with pytest.raises(ValueError, match="ROADMAP"):
        kw.wola_synthesis(torch.zeros((2, 4, 98), device=cuda,
                                      dtype=torch.complex64),
                          torch.zeros((2, 96), device=cuda))
    with pytest.raises(ValueError, match="ROADMAP"):
        kw.wola_synthesis(torch.zeros((2, 4, 130), device=cuda,
                                      dtype=torch.complex128),
                          torch.zeros((2, 128), device=cuda,
                                      dtype=torch.float64))
    assert kw.wola_synthesis.launches == before
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


def _gate_subset(kind, rng, b, t, nib):
    """A (B, T, NIB) gate: a random share, a cluster (one bin over all
    frames, one frame over all bins, the pairs along a tile's edges: frame
    31 / 32 and bin 7 / 8), none or all."""
    g = np.zeros((b, t, nib), bool)
    if kind.startswith("random"):
        g = rng.random((b, t, nib)) < int(kind[6:]) / 100
    elif kind == "one_bin":
        g[:, :, nib // 2] = True
    elif kind == "one_frame":
        g[:, t // 2, :] = True
    elif kind == "tile_edge":
        g[:, 31:33, :] = True
        g[:, :, 7:9] = True
    elif kind == "all":
        g[:] = True
    return g


@pytest.mark.parametrize("kind", ["random5", "random17", "random50",
                                  "one_bin", "one_frame", "tile_edge", "none",
                                  "all"])
@pytest.mark.parametrize("m,w", [(3, 10), (16, 10), (32, 10), (16, 162)])
@pytest.mark.parametrize("b", [1, 3])
def test_mvdr_stream_gate_subsets_are_exact(cuda, kind, m, w, b):
    """The kernel solves only the gated pairs, each block its own list of
    them: a pair's output under any gate G equals its output with every
    pair gated, bit for bit, where G passes, and 0.01 x[mic 0] where it
    fails; ``slot_counts`` grows by G's pairs exactly and by the slots of
    the warps that ran (each block's pairs rounded up to a warp's problems,
    64 / MP)."""
    rng = np.random.default_rng(1000 * m + w + b)
    t, nib, u = 70, 37, 2
    nb = 2 * nib + 5
    lead = (b,) if b > 1 else ()
    x = _cplx(rng, (t,) + lead + (m, nb), cuda)
    hist = _cplx(rng, lead + (w, m, nib), cuda)
    d = _cplx(rng, (u, m, nib), cuda)
    ib = torch.as_tensor(np.sort(rng.choice(np.arange(1, nb), nib,
                                            replace=False)), device=cuda)
    w_idx = torch.as_tensor(rng.integers(0, u, lead + (t,)), device=cuda)
    g = _gate_subset(kind, rng, b, t, nib)
    gate = torch.as_tensor(g.reshape(lead + (t, nib)), device=cuda)
    y_all = km.mvdr_stream(x, hist, d, w_idx, torch.ones_like(gate), ib)
    before = km.mvdr_stream.slot_counts()
    got = km.mvdr_stream(x, hist, d, w_idx, gate, ib)
    after = km.mvdr_stream.slot_counts()
    x0 = x.index_select(-1, ib)[..., 0, :]                   # (T, [B,] NIB)
    passthrough = 0.01 * (x0.transpose(0, 1) if b > 1 else x0)
    assert torch.equal(got[gate], y_all[gate])
    assert torch.equal(got[~gate], passthrough[~gate])
    per_block = np.pad(g, ((0, 0), (0, -t % 32), (0, -nib % 8))).reshape(
        b, -(-t // 32), 32, -(-nib // 8), 8).sum(axis=(2, 4))
    warp = 64 // max(4, 1 << (m - 1).bit_length())
    assert after[0] - before[0] == int(g.sum())
    assert after[1] - before[1] == int((-(-per_block // warp) * warp).sum())
    if kind == "all":
        ref = km.mvdr_stream_plain(x, hist, d, w_idx, gate, ib)
        assert torch.isfinite(torch.view_as_real(got)).all()
        assert _rel(got, ref) < MVDR_REL


def _hpd(rng, b, m, device):
    a = _cplx(rng, (b, m, m), device)
    return (a @ a.conj().transpose(1, 2) / m
            + 0.5 * torch.eye(m, device=device)).contiguous()


@pytest.mark.parametrize("m", [1, 2, 3, 5, 16, 17, 32])
@pytest.mark.parametrize("b", [1, 37, 1000, 1001])
@pytest.mark.parametrize("polish", [False, True])
def test_gj_inverse_kernel_matches_plain(cuda, m, b, polish):
    """Every lane count (4, 8, 16, 32 lanes a matrix, with lanes past M),
    one matrix to many, and B = 1001, whose last tile of 8, 4 or 2 matrices
    and last block of four warps are ragged: one launch."""
    rng = np.random.default_rng(m + b)
    a = _hpd(rng, b, m, cuda)
    before = kl.gj_inverse.launches
    got = kl.gj_inverse(a, polish=polish)
    torch.cuda.synchronize()
    assert kl.gj_inverse.launches == before + 1
    ref = kl.gj_inverse_plain(a, polish=polish)
    assert got.shape == a.shape and _rel(got, ref) < REL
    eye = torch.eye(m, device=cuda, dtype=a.dtype)
    assert float((a @ got - eye).abs().max()) < 1e-4


@pytest.mark.parametrize("m", [3, 16, 32])
@pytest.mark.parametrize("polish", [False, True])
def test_gj_inverse_kernel_nan_positions_match_plain(cuda, m, polish):
    """The cold-start block (R = 0) and a block whose middle mic is silent
    (a zero row and column: an exact zero pivot at its step) give NaN
    exactly where the plain version does; the finite matrices beside them
    in the same tiles stay within REL of plain."""
    rng = np.random.default_rng(300 + m)
    a = _hpd(rng, 37, m, cuda)
    a[:9] = 0
    a[9:18, m // 2, :] = 0
    a[9:18, :, m // 2] = 0
    got = kl.gj_inverse(a, polish=polish)
    ref = kl.gj_inverse_plain(a, polish=polish)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.isnan(got[:18]).all()
    assert _rel(got[18:], ref[18:]) < REL


@pytest.mark.parametrize("polish", [False, True])
def test_gj_inverse_kernel_repeats_bit_for_bit(cuda, polish):
    """chip_smoke.py's dense block shape (82 frames x 678 bins of 16 x 16
    covariances, rank 10 under a 1e-3 loading): a second call on the same
    input gives the same output bit for bit."""
    rng = np.random.default_rng(13)
    b, m, k = 55596, 16, 10
    x = _cplx(rng, (b, m, k), cuda)
    a = x @ x.conj().transpose(1, 2) / k
    tr = torch.diagonal(a, dim1=1, dim2=2).real.mean(-1)
    a = (a + 1e-3 * tr[:, None, None] * torch.eye(m, device=cuda)).contiguous()
    first = kl.gj_inverse(a, polish=polish)
    second = kl.gj_inverse(a, polish=polish)
    torch.cuda.synchronize()
    assert torch.isfinite(torch.view_as_real(first)).all()
    assert torch.equal(first, second)


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
    """Random constraint sets: row 0 with min(S, 3, M) active slots, row 1
    with min(S, 2, M - 1) and the row-0 quirk (mic 0's row zero); the other
    slots inactive (zero columns). On M >= 3 mics that is 3 and 2; fewer
    mics keep no more active slots than the rows that can hold them, or the
    inner system is singular."""
    c = _cplx(rng, (u, s, m, nib), "cpu")
    c[0, min(3, m):] = 0
    c[1, min(2, m - 1):] = 0
    c[1, :, 0] = 0
    return c.to(device)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 12, 16, 17, 32])
@pytest.mark.parametrize("s", [1, 3, 16])
def test_lcmv_stream_kernel_matches_plain(cuda, m, s):
    """Inactive slots, the row-0 quirk, two control rows, a band that is
    not contiguous, ragged tiles and a random gate; odd and
    non-power-of-two mic counts, one lane pair (M <= 4) and S > M."""
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


@pytest.mark.parametrize("w", [1, 10])
@pytest.mark.parametrize("gate_kind", ["all", "none"])
@pytest.mark.parametrize("m,s", [(16, 1), (16, 3), (5, 3)])
def test_lcmv_stream_kernel_window_and_gate_edges(cuda, w, gate_kind, m, s):
    """A one-frame window (R = x x^H loaded by 0.001 on its diagonal, the
    worst conditioned R the kernel takes) and a gate all on or all off.
    With W = 1 the plain float32 version is itself far from float64, so
    the kernel is held to twice its error against float64 and to three
    times it (or MVDR_REL) against it; gated-off outputs exactly."""
    rng = np.random.default_rng(m * 100 + s * 10 + w)
    t, nib, u = 45, 19, 2
    nb = 2 * nib + 5
    x = _cplx(rng, (t, m, nb), cuda)
    hist = _cplx(rng, (w, m, nib), cuda)
    c = _constraints(rng, u, s, m, nib, cuda)
    ib = torch.as_tensor(np.sort(rng.choice(np.arange(1, nb), nib,
                                            replace=False)), device=cuda)
    idx = torch.as_tensor(rng.integers(0, u, t), device=cuda)
    gate = torch.full((t, nib), gate_kind == "all", dtype=torch.bool,
                      device=cuda)
    got = klc.lcmv_stream(x, hist, c, idx, gate, ib)
    ref = klc.lcmv_stream_plain(x, hist, c, idx, gate, ib)
    f64 = klc.lcmv_stream_plain(x.cdouble(), hist.cdouble(), c.cdouble(),
                                idx, gate, ib)
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert torch.equal(got[~gate], ref[~gate])      # 0.01 * x0, exactly
    if gate_kind == "all":
        plain_err = _rel(ref.cdouble(), f64)
        assert _rel(got, ref) < max(MVDR_REL, 3 * plain_err)
        assert _rel(got.cdouble(), f64) <= max(2 * plain_err, 1e-6)


def _many_constraints(rng, s, m, nib, active, device):
    """One constraint set of s slots with ``active`` nonzero columns: slot
    2 zero and the last s - active - 1 slots zero, so that the inner system
    runs on slots that are not contiguous."""
    c = _cplx(rng, (1, s, m, nib), "cpu")
    c[0, 2] = 0
    c[0, active + 1:] = 0
    return c.to(device)


@pytest.mark.parametrize("m,s,active", [(8, 8, 6), (16, 8, 7),
                                        (16, 16, 12), (32, 16, 15)])
def test_lcmv_kernels_with_many_active_slots(cuda, m, s, active):
    """More than four nonzero constraint columns (the inner system without
    G^-1 in registers on 16 mics and fewer), with a zero slot between them:
    the stream kernel and the fused kernel against their plain versions,
    and the fused kernel's refinement off (as the TPU kernel) against
    float64 too."""
    rng = np.random.default_rng(500 + m + s + active)
    t, nib, w = 40, 19, 24
    nb = 2 * nib + 5
    x = _cplx(rng, (t, m, nb), cuda)
    hist = _cplx(rng, (w, m, nib), cuda)
    c = _many_constraints(rng, s, m, nib, active, cuda)
    ib = torch.as_tensor(np.sort(rng.choice(np.arange(1, nb), nib,
                                            replace=False)), device=cuda)
    idx = torch.zeros(t, dtype=torch.int64, device=cuda)
    gate = torch.as_tensor(rng.random((t, nib)) < 0.7, device=cuda)
    got = klc.lcmv_stream(x, hist, c, idx, gate, ib)
    ref = klc.lcmv_stream_plain(x, hist, c, idx, gate, ib)
    f64 = klc.lcmv_stream_plain(x.cdouble(), hist.cdouble(), c.cdouble(),
                                idx, gate, ib)
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert _rel(got, ref) < MVDR_REL
    assert _rel(got.cdouble(), f64) <= max(2 * _rel(ref.cdouble(), f64),
                                           1e-6)
    hop, tf = 128, 60
    xa, tail, prev, ibf, thr = _fused_inputs(rng, m, tf, hop, nib, cuda)
    hf = _cplx(rng, (w, m, nib), cuda)
    idf = torch.zeros(tf, dtype=torch.int64, device=cuda)
    got = kmega.lcmv_mega(xa, tail, prev, hf, c, idf, ibf, 2 * hop, w, thr)
    ref = kmega.lcmv_mega(*(a.cpu() for a in (xa, tail, prev, hf, c, idf,
                                              ibf)), 2 * hop, w, thr)
    f64 = kmega.lcmv_mega(*(a.cpu().double() for a in (xa, tail, prev)),
                          *(a.cpu().cdouble() for a in (hf, c)), idf.cpu(),
                          ibf.cpu(), 2 * hop, w, thr)
    plain_err = _rel(ref[0].double(), f64[0])
    assert torch.isfinite(got[0]).all()
    assert _rel(got[0].cpu(), ref[0]) < max(MVDR_REL, 3 * plain_err)
    assert _rel(got[0].cpu().double(), f64[0]) <= max(2 * plain_err, 1e-6)


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


@pytest.mark.parametrize("solver", ["auto", "mega"])
@pytest.mark.parametrize("interf", [(70.0,), (70.0, -60.0, 120.0)])
def test_lcmv_more_slots_than_mics_on_cuda(cuda, solver, interf):
    """aira3 (3 mics) with 1 and 3 static interferers (S = 2 < M and
    S = 4 > M) through the stream and fused kernels. With S < M the card
    is held to the float64 CPU path (the BASELINE budget); with S > M the
    inner matrix is singular and the output is round-off
    (tests/test_torch_lcmv.py::
    test_lcmv_more_slots_than_mics_against_the_jax_model), so the call is
    held to its launches, its shape and the quiet lead-in's passthrough."""
    import dataclasses
    cfg = dataclasses.replace(
        load_array_config(os.path.join(ROOT, "beamform_tpu_torch", "configs",
                                       "aira3.yaml")),
        interference_angles=interf)
    rng = np.random.default_rng(23)
    x = (0.1 * rng.standard_normal((3, 40 * 1024))).astype(np.float32)
    x[:, :12 * 1024] *= 1e-4                  # quiet lead-in > past_windows
    params = dict(load_launch_params("lcmv"), solver=solver)
    kernel = klc.lcmv_stream if solver == "auto" else kmega.mega_stream
    before = kernel.launches
    got = run_offline("lcmv", x, engine=EngineConfig(), array_cfg=cfg,
                      theta=20.0, params=params, device=cuda)
    assert kernel.launches == before + 1
    ref = run_offline("lcmv", x, engine=EngineConfig(dtype="float64"),
                      array_cfg=cfg, theta=20.0, params=params, device="cpu")
    assert got.shape == ref.shape
    lead = 11 * 1024
    assert np.abs(got[:lead] - ref[:lead]).max() <= 1e-9
    if len(interf) + 1 < 3:
        assert np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-3      # BASELINE budget


def test_lcmv_stream_s1_stream_equals_mvdr_stream_on_cuda(cuda):
    """LCMV at one slot and MVDR, both ``stream`` on the card, on the same
    16-mic input: the two kernels share tri_solve.cuh's refined solve and
    differ only in LCMV's scalar inner system, so the audio agrees within
    1e-6 (chip_smoke.py's LCMV_MVDR_TOL)."""
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    x = _lcmv_scene(60, 8)
    outs = {}
    for node in ("lcmv", "mvdr"):
        params = dict(load_launch_params(node), solver="stream")
        outs[node] = run_offline(node, x, engine=EngineConfig(),
                                 array_cfg=cfg, theta=20.0, params=params,
                                 device=cuda)
    assert np.isfinite(outs["mvdr"]).all()
    assert np.abs(outs["lcmv"] - outs["mvdr"]).max() <= 1e-6


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


# ------------------------------------------------ fused kernels (mega, GSS)


def _fused_inputs(rng, m, t, hop, nib, device):
    """Audio with quiet hops (gated-off frames), the two carries, a band
    that is neither contiguous nor starting at bin 1, and the gate
    threshold at the median of the band's statistic (a mixed gate)."""
    x = 0.1 * rng.standard_normal((m, t * hop))
    x[:, 3 * hop:6 * hop] *= 1e-4
    tail = 0.1 * rng.standard_normal((m, hop))
    prev = rng.standard_normal(hop)
    ib = np.sort(rng.choice(np.arange(1, hop), nib, replace=False))
    x, tail, prev = (torch.as_tensor(a, dtype=torch.float32, device=device)
                     for a in (x, tail, prev))
    ib = torch.as_tensor(ib, device=device)
    mag = kw.wola_analysis_plain(x, tail, with_mag=True)[1]
    # the threshold in the widest gap between the statistic's values near
    # the median, so that no pair sits on it and no rounding flips a gate
    v = mag.index_select(1, ib).flatten().sort().values.cpu().numpy()
    k = len(v) * 2 // 5 + np.argmax(np.diff(v[len(v) * 2 // 5:
                                                len(v) * 3 // 5]))
    return x, tail, prev, ib, float((v[k] + v[k + 1]) / 2)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 12, 16, 17, 32])
@pytest.mark.parametrize("s", [0, 1, 3, 16])
def test_mega_kernel_matches_plain(cuda, m, s):
    """MVDR (s = 0) and LCMV with s slots (inactive slots and the row-0
    quirk from ``_constraints``) over 2.3 segments of frames, a theta
    timeline of two control rows and a mixed gate: audio, history and
    carry against the plain float32 version, and the audio against the
    plain version in float64."""
    rng = np.random.default_rng(100 + m * 10 + s)
    hop, t, nib, w, u = 128, 220, 37, 6, 2
    x, tail, prev, ib, thr = _fused_inputs(rng, m, t, hop, nib, cuda)
    hist = _cplx(rng, (w, m, nib), cuda)
    idx = torch.as_tensor(rng.integers(0, u, t), device=cuda)
    if s == 0:
        ctrl = _cplx(rng, (u, m, nib), cuda)
        fused = kmega.mvdr_mega
    else:
        ctrl = _constraints(rng, u, s, m, nib, cuda)
        fused = kmega.lcmv_mega
    before = kmega.mega_stream.launches
    got = fused(x, tail, prev, hist, ctrl, idx, ib, 2 * hop, w, thr)
    torch.cuda.synchronize()
    assert kmega.mega_stream.launches == before + 1
    ref = fused(*(a.cpu() for a in (x, tail, prev, hist, ctrl, idx, ib)),
                2 * hop, w, thr)
    f64 = fused(*(a.cpu().double() for a in (x, tail, prev)),
                *(a.cpu().cdouble() for a in (hist, ctrl)), idx.cpu(),
                ib.cpu(), 2 * hop, w, thr)
    audio, new_hist, new_prev = (a.cpu() for a in got)
    assert audio.shape == (t * hop,) and audio.dtype == torch.float32
    assert torch.isfinite(audio).all()
    # the solves are unrefined (as the TPU kernel's default), so where the
    # constraint set is ill-conditioned (S = M = 3) the plain float32
    # version is itself 1.7e-2 of peak from float64: the kernel is held to
    # twice that error against float64, and to three times it (or
    # MVDR_REL) against the plain version
    plain_err = _rel(ref[0].double(), f64[0])
    assert _rel(audio, ref[0]) < max(MVDR_REL, 3 * plain_err)
    assert _rel(audio.double(), f64[0]) <= max(2 * plain_err, 1e-6)
    assert _rel(new_hist, ref[1]) < REL
    assert _rel(new_prev, ref[2]) < MVDR_REL


@pytest.mark.parametrize("w", [1, 6])
@pytest.mark.parametrize("gate_kind", ["all", "none"])
@pytest.mark.parametrize("s", [0, 3])
def test_mega_kernel_window_and_gate_edges(cuda, w, gate_kind, s):
    """A one-frame window and a gate all on (threshold -1) or all off (a
    threshold above every statistic): audio, history and carry against the
    plain version, the audio also against float64 (all on: twice the plain
    float32 version's error; all off: the passthrough, 1e-5 of peak as the
    synthesis)."""
    rng = np.random.default_rng(300 + w * 10 + s)
    m, hop, t, nib, u = 16, 128, 120, 37, 2
    x, tail, prev, ib, _ = _fused_inputs(rng, m, t, hop, nib, cuda)
    thr = -1.0 if gate_kind == "all" else 1e30
    hist = _cplx(rng, (w, m, nib), cuda)
    idx = torch.as_tensor(rng.integers(0, u, t), device=cuda)
    if s == 0:
        ctrl = _cplx(rng, (u, m, nib), cuda)
        fused = kmega.mvdr_mega
    else:
        ctrl = _constraints(rng, u, s, m, nib, cuda)
        fused = kmega.lcmv_mega
    got = fused(x, tail, prev, hist, ctrl, idx, ib, 2 * hop, w, thr)
    ref = fused(*(a.cpu() for a in (x, tail, prev, hist, ctrl, idx, ib)),
                2 * hop, w, thr)
    f64 = fused(*(a.cpu().double() for a in (x, tail, prev)),
                *(a.cpu().cdouble() for a in (hist, ctrl)), idx.cpu(),
                ib.cpu(), 2 * hop, w, thr)
    audio, new_hist, new_prev = (a.cpu() for a in got)
    assert torch.isfinite(audio).all()
    plain_err = _rel(ref[0].double(), f64[0])
    if gate_kind == "all":
        assert _rel(audio, ref[0]) < max(MVDR_REL, 3 * plain_err)
        assert _rel(audio.double(), f64[0]) <= max(2 * plain_err, 1e-6)
    else:
        assert _rel(audio, ref[0]) < REL
    assert _rel(new_hist, ref[1]) < REL
    assert _rel(new_prev, ref[2]) < MVDR_REL


def test_mega_kernel_short_chunks_and_history(cuda):
    """Chunks shorter than W frames (the history is partly the carried
    one), a one-frame chunk, and chunked calls equal to one call bit for
    bit."""
    rng = np.random.default_rng(7)
    hop, t, nib, w, m = 256, 40, 50, 10, 16
    x, tail, prev, ib, thr = _fused_inputs(rng, m, t, hop, nib, cuda)
    hist = _cplx(rng, (w, m, nib), cuda)
    d = _cplx(rng, (1, m, nib), cuda)
    idx = torch.zeros(t, dtype=torch.int64, device=cuda)
    whole = kmega.mvdr_mega(x, tail, prev, hist, d, idx, ib, 2 * hop, w, thr)
    outs, state = [], (tail, prev, hist)
    for f0, f1 in ((0, 1), (1, 4), (4, 17), (17, 40)):
        xc = x[:, f0 * hop:f1 * hop].contiguous()
        a, h, p = kmega.mvdr_mega(xc, state[0], state[1], state[2], d,
                                  idx[f0:f1], ib, 2 * hop, w, thr)
        ref = kmega.mvdr_mega(*(v.cpu() for v in (xc, state[0], state[1],
                                                  state[2], d)),
                              idx[f0:f1].cpu(), ib.cpu(), 2 * hop, w, thr)
        assert _rel(h.cpu(), ref[1]) < REL
        outs.append(a)
        state = (xc[:, -hop:].contiguous(), p, h)
    assert torch.equal(torch.cat(outs), whole[0])
    assert torch.equal(state[2], whole[1]) and torch.equal(state[1], whole[2])


@pytest.mark.parametrize("m", [3, 16, 32])
@pytest.mark.parametrize("s", [1, 3, 16])
def test_gss_kernel_matches_plain(cuda, m, s):
    """Two control rows (one with the row-0 quirk), inactive slots with
    zero rows of A^H and of W, resets at the start and mid-stream, a mixed
    gate, 2.3 segments of frames: audio, W and the carry against the plain
    float32 version, and the audio against the plain float64 version."""
    rng = np.random.default_rng(200 + m * 10 + s)
    hop, t, nib, u = 128, 220, 37, 2
    mu, lam = 0.01, 0.5
    x, tail, prev, ib, thr = _fused_inputs(rng, m, t, hop, nib, cuda)
    ah = _constraints(rng, u, s, m, nib, cuda)
    ah = ah / ah.abs().clamp_min(1e-30) * (ah != 0)     # unit-modulus A^H
    w0 = _cplx(rng, (nib, s, m), cuda) * 0.1
    w0[:, 3:] = 0
    idx = torch.as_tensor(np.repeat([0, 1, 0], [80, 70, 70]), device=cuda)
    reset = torch.zeros(t, dtype=torch.bool, device=cuda)
    reset[[0, 80, 150]] = True
    before = kgss.gss_mega.launches
    got = kgss.gss_mega(x, tail, prev, w0, ah, idx, reset, ib, 2 * hop, thr,
                        mu, lam)
    torch.cuda.synchronize()
    assert kgss.gss_mega.launches == before + 1
    cpu = [a.cpu() for a in (x, tail, prev, w0, ah, idx, reset, ib)]
    ref = kgss.gss_mega(*cpu, 2 * hop, thr, mu, lam)
    f64 = kgss.gss_mega(*(a.double() for a in cpu[:3]),
                        *(a.cdouble() for a in cpu[3:5]), *cpu[5:],
                        2 * hop, thr, mu, lam)
    audio, w_new, new_prev = (a.cpu() for a in got)
    assert audio.shape == (t * hop,) and w_new.shape == (nib, s, m)
    assert torch.isfinite(audio).all()
    assert _rel(audio, ref[0]) < MVDR_REL
    assert _rel(audio.double(), f64[0]) <= max(
        2 * _rel(ref[0].double(), f64[0]), 1e-6)
    assert _rel(w_new, ref[1]) < MVDR_REL
    assert _rel(new_prev, ref[2]) < MVDR_REL
    assert not w_new[:, 3:].any()                   # inactive slots stay 0


def test_gss_kernel_chunks_equal_one_call(cuda):
    rng = np.random.default_rng(9)
    hop, t, nib, m, s = 1024, 30, 60, 16, 3
    x, tail, prev, ib, thr = _fused_inputs(rng, m, t, hop, nib, cuda)
    ah = _constraints(rng, 2, s, m, nib, cuda)
    w0 = torch.zeros((nib, s, m), dtype=torch.complex64, device=cuda)
    idx = torch.zeros(t, dtype=torch.int64, device=cuda)
    reset = torch.zeros(t, dtype=torch.bool, device=cuda)
    reset[0] = True
    args = (2 * hop, thr, 0.01, 0.0)
    whole = kgss.gss_mega(x, tail, prev, w0, ah, idx, reset, ib, *args)
    outs, state = [], (tail, prev, w0)
    for f0, f1 in ((0, 1), (1, 11), (11, 30)):
        xc = x[:, f0 * hop:f1 * hop].contiguous()
        a, w_new, p = kgss.gss_mega(xc, state[0], state[1], state[2], ah,
                                    idx[f0:f1], reset[f0:f1], ib, *args)
        outs.append(a)
        state = (xc[:, -hop:].contiguous(), p, w_new)
    assert torch.equal(torch.cat(outs), whole[0])
    assert torch.equal(state[2], whole[1]) and torch.equal(state[1], whole[2])


@pytest.mark.parametrize("resets", [(), (0, 25)])
def test_gss_kernel_sixteen_slots_two_active(cuda, resets):
    """The CLI's capacity, S = 16, with two active slots (0 and 5; the
    other rows of A^H and of the starting W zero), with and without
    resets: audio, W and the carry against the plain float32 version, the
    audio against the plain float64 version, the inactive rows of W
    exactly zero, and chunks equal to one call bit for bit."""
    rng = np.random.default_rng(31)
    hop, t, nib, m, s = 1024, 40, 60, 16, 16
    mu, lam = 0.01, 0.5
    x, tail, prev, ib, thr = _fused_inputs(rng, m, t, hop, nib, cuda)
    ah = _cplx(rng, (1, s, m, nib), cuda)
    ah = ah / ah.abs()                              # unit-modulus A^H
    keep = torch.zeros(s, dtype=torch.bool, device=cuda)
    keep[[0, 5]] = True
    ah = (ah * keep[None, :, None, None]).contiguous()
    w0 = (_cplx(rng, (nib, s, m), cuda) * 0.1
          * keep[None, :, None]).contiguous()
    idx = torch.zeros(t, dtype=torch.int64, device=cuda)
    reset = torch.zeros(t, dtype=torch.bool, device=cuda)
    reset[list(resets)] = True
    args = (2 * hop, thr, mu, lam)
    got = kgss.gss_mega(x, tail, prev, w0, ah, idx, reset, ib, *args)
    cpu = [a.cpu() for a in (x, tail, prev, w0, ah, idx, reset, ib)]
    ref = kgss.gss_mega(*cpu, *args)
    f64 = kgss.gss_mega(*(a.double() for a in cpu[:3]),
                        *(a.cdouble() for a in cpu[3:5]), *cpu[5:], *args)
    audio, w_new, new_prev = (a.cpu() for a in got)
    assert torch.isfinite(audio).all()
    assert _rel(audio, ref[0]) < MVDR_REL
    assert _rel(audio.double(), f64[0]) <= max(
        2 * _rel(ref[0].double(), f64[0]), 1e-6)
    assert _rel(w_new, ref[1]) < MVDR_REL
    assert _rel(new_prev, ref[2]) < MVDR_REL
    assert not w_new[:, ~keep.cpu()].any()
    outs, state = [], (tail, prev, w0)
    for f0, f1 in ((0, 1), (1, 26), (26, 40)):
        xc = x[:, f0 * hop:f1 * hop].contiguous()
        a, w_c, p = kgss.gss_mega(xc, state[0], state[1], state[2], ah,
                                  idx[f0:f1], reset[f0:f1], ib, *args)
        outs.append(a)
        state = (xc[:, -hop:].contiguous(), p, w_c)
    assert torch.equal(torch.cat(outs), got[0])
    assert torch.equal(state[2], got[1]) and torch.equal(state[1], got[2])


def test_fused_kernels_index_out_of_range_gives_nan(cuda):
    """A control index out of range makes its frame's solved output NaN,
    and the frame's audio (two hops) non-finite; a bin index outside
    [1, nfft / 2) makes every frame NaN. Nothing is dereferenced."""
    rng = np.random.default_rng(11)
    hop, t, nib, w, m = 128, 24, 20, 4, 4
    x, tail, prev, ib, _ = _fused_inputs(rng, m, t, hop, nib, cuda)
    hist = _cplx(rng, (w, m, nib), cuda)
    d = _cplx(rng, (2, m, nib), cuda)
    ah = _constraints(rng, 2, 2, m, nib, cuda)
    w0 = torch.zeros((nib, 2, m), dtype=torch.complex64, device=cuda)
    reset = torch.zeros(t, dtype=torch.bool, device=cuda)
    reset[0] = True
    idx = torch.zeros(t, dtype=torch.int64, device=cuda)
    bad = idx.clone()
    bad[10] = 2
    for out in (kmega.mvdr_mega(x, tail, prev, hist, d, bad, ib, 2 * hop, w,
                                0.0)[0],
                kgss.gss_mega(x, tail, prev, w0, ah, bad, reset, ib, 2 * hop,
                              0.0, 0.01, 0.0)[0]):
        finite = torch.isfinite(out).cpu().numpy()
        assert not finite[10 * hop:11 * hop].any()
        assert finite[:9 * hop].all()
    for bad_bin in (0, hop):
        ib2 = ib.clone()
        ib2[3] = bad_bin
        assert torch.isnan(kmega.mvdr_mega(x, tail, prev, hist, d, idx, ib2,
                                           2 * hop, w, 0.0)[0]).all()
        assert torch.isnan(kgss.gss_mega(x, tail, prev, w0, ah, idx, reset,
                                         ib2, 2 * hop, 0.0, 0.01,
                                         0.0)[0]).all()


def test_fused_kernels_raise_on_what_they_do_not_take(cuda):
    hop, t, m, nib, w = 128, 4, 4, 3, 2
    z = torch.zeros
    c64 = dict(dtype=torch.complex64, device=cuda)
    x = z((m, t * hop), device=cuda)
    tail, prev = z((m, hop), device=cuda), z(hop, device=cuda)
    hist, d = z((w, m, nib), **c64), z((1, m, nib), **c64)
    idx, ib = z(t, dtype=torch.int64, device=cuda), torch.arange(
        1, nib + 1, device=cuda)
    with pytest.raises(ValueError, match="ROADMAP"):
        kmega.mvdr_mega(x.double(), tail.double(), prev.double(),
                        hist.cdouble(), d.cdouble(), idx, ib, 2 * hop, w, 0.)
    with pytest.raises(ValueError, match="M <= 32"):
        kmega.mvdr_mega(z((40, t * hop), device=cuda), z((40, hop),
                                                          device=cuda),
                        prev, z((w, 40, nib), **c64), z((1, 40, nib), **c64),
                        idx, ib, 2 * hop, w, 0.)
    with pytest.raises(ValueError, match="S <= 16"):
        kmega.lcmv_mega(x, tail, prev, hist, z((1, 17, m, nib), **c64), idx,
                        ib, 2 * hop, w, 0.)
    w0, ah = z((nib, 17, m), **c64), z((1, 17, m, nib), **c64)
    with pytest.raises(ValueError, match="S <= 16"):
        kgss.gss_mega(x, tail, prev, w0, ah, idx, idx.bool(), ib, 2 * hop,
                      0., 0.01, 0.)


@pytest.mark.parametrize("node,solver,scene", [
    ("mvdr", "mega", "noise"), ("lcmv", "mega", "static"),
    ("lcmv", "mega", "events"), ("gss", "auto", "static"),
    ("gss", "auto", "events")])
def test_fused_paths_on_cuda_match_float64_cpu(cuda, node, solver, scene):
    """The fused paths of MVDR, LCMV and GSS at 16 mics, hop 1024, against
    the float64 CPU path, with each path's exact launches: the fused
    kernel once and no other kernel."""
    import dataclasses
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    t = 60
    x = _lcmv_scene(t, 8)
    interference = None
    if scene == "static":
        cfg = dataclasses.replace(cfg, interference_angles=(70.0, -60.0))
    elif scene == "events":
        interference = replay_interference_events(
            t, [70.0], [InterfEvent(25, 2, -60.0), InterfEvent(45, 2, 70.5)],
            threshold=1.0, capacity=15)
    params = dict(load_launch_params(node), solver=solver)
    model = get_model(node, EngineConfig(), cfg, params, device=cuda)
    counters = (kw.wola_analysis, kw.wola_synthesis, km.mvdr_stream,
                klc.lcmv_stream, kl.gj_inverse, kmega.mega_stream,
                kgss.gss_mega)
    before = [f.launches for f in counters]
    kw_ = {} if interference is None else dict(interference=interference)
    got = model.process(x, 20.0, **kw_).cpu().numpy()
    ran = [f.launches - b for f, b in zip(counters, before)]
    assert ran == [0, 0, 0, 0, 0, int(node != "gss"), int(node == "gss")]
    ref = run_offline(node, x, engine=EngineConfig(dtype="float64"),
                      array_cfg=cfg, theta=20.0,
                      params=dict(params, solver="scan" if node == "gss"
                                  else "stream"),
                      device="cpu", interference=interference)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-3      # BASELINE budget


@pytest.mark.parametrize("node,solver", [("mvdr", "mega"), ("lcmv", "mega"),
                                         ("gss", "auto")])
def test_fused_paths_chunks_equal_offline_on_cuda(cuda, node, solver):
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    x = _lcmv_scene(49, 6)
    params = dict(load_launch_params(node), solver=solver)
    model = get_model(node, EngineConfig(), cfg, params, device=cuda)
    offline = model.process(x, 20.0)
    sess = StreamingSession(model)
    chunks = [sess.process(x[:, f0 * 1024:(f0 + 7) * 1024], 20.0)
              for f0 in range(0, 49, 7)]
    assert torch.equal(torch.cat(chunks), offline)


# ------------------------------------------------- phase, phasempf, mcra

def _assert_close_mod_flips(got, ref, tight=5e-5, frac=1e-3, ceil=5e-2):
    """The JAX package's contract for the phase masks
    (tests/test_phase_mask.py ``assert_close_mod_flips``): relative to the
    peak of ``ref``, the 99.9th percentile of the deviation under
    ``tight``, at most ``frac`` of the samples over it (the bins a
    rounding difference moves across a binary mask's threshold), and none
    over ``ceil``."""
    got, ref = (np.asarray(a.cpu()) if torch.is_tensor(a) else a
                for a in (got, ref))
    dev = np.abs(got - ref) / max(np.abs(ref).max(), 1e-12)
    assert np.percentile(dev, 99.9) < tight, np.percentile(dev, 99.9)
    assert np.mean(dev > tight) <= frac, np.mean(dev > tight)
    assert dev.max() < ceil, dev.max()


def _phase_operands(m, t, nb, u, seed, device):
    """Spectra (T, M, NB) of a source steered by one of ``u`` rows under
    a noise level that rises over the bins, so the bins' mean pair
    distances spread across the masks' thresholds; the steering rows
    (U, M, NB) and each frame's row (T,)."""
    from beamform_tpu_torch.geometry import (ArrayGeometry, steering_delays,
                                             steering_weights)
    rng = np.random.default_rng(seed)
    geom = ArrayGeometry.from_xy(rng.uniform(-0.1, 0.1, (m, 2)).tolist())
    freqs = torch.linspace(0.0, 24000.0, nb, dtype=torch.float64)
    w = steering_weights(freqs, steering_delays(geom, np.linspace(20, -40,
                                                                  u)))
    idx = np.sort(rng.integers(0, u, t))
    s = rng.standard_normal((t, 1, nb)) + 1j * rng.standard_normal((t, 1, nb))
    noise = (rng.standard_normal((t, m, nb))
             + 1j * rng.standard_normal((t, m, nb)))
    spec = s * w.numpy()[idx] + noise * np.linspace(0.01, 2.0, nb)
    return (torch.as_tensor(spec, dtype=torch.complex64, device=device),
            w.to(torch.complex64).to(device),
            torch.as_tensor(idx, dtype=torch.int64, device=device))


PM_SHAPES = [(3, 40, 130, 1), (16, 40, 130, 2), (32, 9, 258, 3),
             (16, 1407, 1026, 1), (2, 33, 77, 1), (5, 20, 129, 2),
             (17, 12, 66, 2), (8, 50, 1025, 3), (4, 50, 513, 1)]


@pytest.mark.parametrize("m,t,nb,u", PM_SHAPES)
def test_phase_mask_kernel_matches_plain(cuda, m, t, nb, u):
    """Ragged bins (frames that share a block of the flat grid), an odd
    bin count and fewer bins than a block, 2 to 32 mics (4, 8, 16 and 32
    on the kernels with the count a constant, the others on the guarded
    ones), several steering rows, and the main path's shape (16 mics,
    1026 bins, 1407 frames)."""
    from beamform_tpu_torch.kernels import phase_mask as kpm
    spec, w, idx = _phase_operands(m, t, nb, u, m + t, cuda)
    args = (spec, w, idx, 0.35, 0.004, 0.1, 2 * (nb - 2))
    before = kpm.phase_mask.launches
    got = kpm.phase_mask(*args)
    torch.cuda.synchronize()
    assert kpm.phase_mask.launches == before + 1
    assert got.shape == (t, nb) and got.dtype == torch.complex64
    assert torch.equal(got[:, 0], spec[:, 0, 0])
    _assert_close_mod_flips(got, kpm.phase_mask_plain(*args))


@pytest.mark.parametrize("m", [3, 16])
def test_phase_mask_index_out_of_range_gives_nan(cuda, m):
    """A w_idx entry outside [0, U) is never dereferenced: its frame is
    NaN, in the phase mask and in the MPF beams' output, and the other
    frames are the plain version's."""
    from beamform_tpu_torch.config import PhasempfParams
    from beamform_tpu_torch.kernels import phase_mask as kpm
    spec, w, idx = _phase_operands(m, 20, 129, 2, 1, cuda)
    idx = idx.clone()
    idx[5], idx[9] = 2, -1
    got = kpm.phase_mask(spec, w, idx, 0.35, 0.004, 0.1, 254)
    torch.cuda.synchronize()
    bad = torch.isnan(torch.view_as_real(got)).all(-1).all(-1)
    assert bad.nonzero().flatten().tolist() == [5, 9]
    keep = ~bad
    ref = kpm.phase_mask_plain(spec[keep], w, idx[keep], 0.35, 0.004, 0.1,
                               254)
    _assert_close_mod_flips(got[keep], ref)
    st = kpm.init_state(kpm.MpfState, 129, torch.float32, cuda)
    y, _ = kpm.mpf_march(spec, w, idx, st, PhasempfParams(), False)
    torch.cuda.synchronize()
    assert torch.isnan(torch.view_as_real(y[[5, 9]])).all()


def _carried(cls, plain_march, nb, device, steps=5):
    """A state of ``cls`` after a few frames of its plain march from zero,
    one frame before a rollover of ``current_l`` (MCRA_L = 7)."""
    from beamform_tpu_torch.kernels import phase_mask as kpm
    st = kpm.init_state(cls, nb, torch.float32, device)
    st = plain_march(st, steps)
    return st._replace(current_l=torch.tensor(7, dtype=torch.int32,
                                              device=device))


MPF_FLAGS = [{}, {"out_only_noise": True}, {"out_only_mcra": True},
             {"bug_dc_zero": False}]


@pytest.mark.parametrize("flags", MPF_FLAGS)
@pytest.mark.parametrize("m,t,nb,u", [(3, 60, 130, 1), (16, 1407, 1026, 2)])
def test_mpf_kernels_match_plain(cuda, m, t, nb, u, flags):
    """The dual beams and the MCRA/MPF march from a carried state across
    a rollover, under each output option."""
    from beamform_tpu_torch.config import PhasempfParams
    from beamform_tpu_torch.kernels import phase_mask as kpm
    flags = dict(flags)
    dc_zero = flags.pop("bug_dc_zero", True)
    p = PhasempfParams(**dict(load_launch_params("phasempf"), MCRA_L=7,
                              **flags))
    spec, w, idx = _phase_operands(m, t, nb, u, 7 * m + t, cuda)
    st0 = _carried(kpm.MpfState, lambda st, n: kpm.mpf_march_plain(
        spec[:n], w, idx[:n], st, p, dc_zero)[1], nb, cuda)
    before = kpm.mpf_march.launches
    y, st = kpm.mpf_march(spec, w, idx, st0, p, dc_zero)
    torch.cuda.synchronize()
    assert kpm.mpf_march.launches == before + 1
    y_ref, st_ref = kpm.mpf_march_plain(spec, w, idx, st0, p, dc_zero)
    _assert_close_mod_flips(y, y_ref)
    assert st.current_l.dtype == torch.int32 and st.first_l.dtype == torch.bool
    assert int(st.current_l) == int(st_ref.current_l)
    assert not bool(st.first_l) and not bool(st_ref.first_l)
    for a, b in zip(st[:7], st_ref[:7]):
        _assert_close_mod_flips(a, b)


@pytest.mark.parametrize("only_noise", [False, True])
@pytest.mark.parametrize("t,nb", [(50, 130), (1407, 1026)])
def test_mcra_march_kernel_matches_plain(cuda, t, nb, only_noise):
    from beamform_tpu_torch.config import McraParams
    from beamform_tpu_torch.kernels import phase_mask as kpm
    from beamform_tpu_torch.models.mcra import freq_smooth
    rng = np.random.default_rng(t)
    env = np.abs(np.sin(np.arange(t) / 9.0))[:, None] + 0.05
    x = torch.as_tensor(env * (rng.standard_normal((t, nb))
                               + 1j * rng.standard_normal((t, nb))),
                        dtype=torch.complex64, device=cuda)
    sq = x.abs() ** 2
    s_f = freq_smooth(sq, x[:, 0].abs())
    p = McraParams(**dict(load_launch_params("mcra"), L=7,
                          out_only_noise=only_noise))
    for dc_zero in (True, False):
        st0 = _carried(kpm.McraState, lambda st, n: kpm.mcra_march_plain(
            s_f[:n], sq[:n], x[:n], st, p, dc_zero)[1], nb, cuda)
        before = kpm.mcra_march.launches
        y, st = kpm.mcra_march(s_f, sq, x, st0, p, dc_zero)
        torch.cuda.synchronize()
        assert kpm.mcra_march.launches == before + 1
        y_ref, st_ref = kpm.mcra_march_plain(s_f, sq, x, st0, p, dc_zero)
        _assert_close_mod_flips(y, y_ref)
        assert int(st.current_l) == int(st_ref.current_l)
        assert bool(st.first_l) == bool(st_ref.first_l) is False
        for a, b in zip(st[:4], st_ref[:4]):
            _assert_close_mod_flips(a, b)


def _march_operands(kernel, t, nb, cuda, L):
    """A march's call: (the wrapper, its plain version, its operands
    before the state, its parameters with MCRA's L = ``L``, a zero
    state). MPF on 16 mics and two steering rows, MCRA on mic 0's
    spectrum under a syllabic envelope."""
    from beamform_tpu_torch.config import McraParams, PhasempfParams
    from beamform_tpu_torch.kernels import phase_mask as kpm
    from beamform_tpu_torch.models.mcra import freq_smooth
    if kernel == "mpf":
        p = PhasempfParams(**dict(load_launch_params("phasempf"), MCRA_L=L))
        ops = _phase_operands(16, t, nb, 2, t + nb, cuda)
        return (kpm.mpf_march, kpm.mpf_march_plain, ops, p,
                kpm.init_state(kpm.MpfState, nb, torch.float32, cuda))
    rng = np.random.default_rng(t + nb)
    env = np.abs(np.sin(np.arange(t) / 9.0))[:, None] + 0.05
    x = torch.as_tensor(env * (rng.standard_normal((t, nb))
                               + 1j * rng.standard_normal((t, nb))),
                        dtype=torch.complex64, device=cuda)
    sq = x.abs() ** 2
    p = McraParams(**dict(load_launch_params("mcra"), L=L))
    return (kpm.mcra_march, kpm.mcra_march_plain,
            (freq_smooth(sq, x[:, 0].abs()), sq, x), p,
            kpm.init_state(kpm.McraState, nb, torch.float32, cuda))


def _chunk(kernel, ops, a, z):
    """Frames a .. z - 1 of a march's operands (the steering rows whole)."""
    if kernel == "mpf":
        return (ops[0][a:z].contiguous(), ops[1], ops[2][a:z].contiguous())
    return tuple(o[a:z].contiguous() for o in ops)


@pytest.mark.parametrize("L", [31, None], ids=["L31", "preset"])
@pytest.mark.parametrize("kernel", ["mpf", "mcra"])
def test_march_kernels_chunks_equal_one_call(cuda, kernel, L):
    """Both march kernels at T = 1407, NB = 1026 in 64-frame chunks with
    the state carried equal one call bit for bit. With L = 31 from a zero
    state current_L rolls over at frame 32 (a segment boundary inside a
    chunk) and then every 32 frames, at every chunk boundary too."""
    t, nb = 1407, 1026
    if L is None:
        L = load_launch_params("mcra" if kernel == "mcra" else "phasempf")[
            "L" if kernel == "mcra" else "MCRA_L"]
    fn, _, ops, p, st0 = _march_operands(kernel, t, nb, cuda, L)
    y, st = fn(*ops, st0, p, True)
    ys, stc, ends = [], st0, []
    for a in range(0, t, 64):
        yc, stc = fn(*_chunk(kernel, ops, a, a + 64), stc, p, True)
        ys.append(yc)
        ends.append(int(stc.current_l))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(ys), y)
    for name, a, b in zip(st._fields, stc, st):
        assert torch.equal(a, b), name
    if L == 31:
        # after frame 64 k + 63 the counter has run 32 frames since the
        # roll-over at frame 64 k + 32: 32, and it rolls at the next frame
        assert ends[1:-1] == [32] * (len(ends) - 2)
        assert ends[0] == 32 and not bool(stc.first_l)


@pytest.mark.parametrize("t", [1, 7, 60, 1407])
@pytest.mark.parametrize("nb", [130, 1026, 129])
@pytest.mark.parametrize("kernel", ["mpf", "mcra"])
def test_march_kernels_ragged_shapes(cuda, kernel, nb, t):
    """Bins not a multiple of a block's 8 (and an odd count, whose rows
    the kernels copy a bin a lane), frames not a multiple of the 32-frame
    segment, from a zero state under L = 7 (current_L rolls over at frame
    8 and every 8 frames on): output and state against the plain version
    under the flip contract, current_L and first_L exact."""
    fn, plain, ops, p, st0 = _march_operands(kernel, t, nb, cuda, 7)
    y, st = fn(*ops, st0, p, True)
    torch.cuda.synchronize()
    y_ref, st_ref = plain(*ops, st0, p, True)
    assert y.shape == (t, nb)
    _assert_close_mod_flips(y, y_ref)
    assert int(st.current_l) == int(st_ref.current_l)
    assert bool(st.first_l) == bool(st_ref.first_l)
    for a, b in zip(st[:-2], st_ref[:-2]):
        _assert_close_mod_flips(a, b)


def _stream_mask_operands(m, t, nb, b, seed, device):
    """B streams' spectra (T, B, M, NB), each _phase_operands' scene of
    its own source under one shared geometry and steering (two rows), and
    each (stream, frame)'s row (B, T)."""
    from beamform_tpu_torch.geometry import (ArrayGeometry, steering_delays,
                                             steering_weights)
    rng = np.random.default_rng(seed)
    geom = ArrayGeometry.from_xy(rng.uniform(-0.1, 0.1, (m, 2)).tolist())
    freqs = torch.linspace(0.0, 24000.0, nb, dtype=torch.float64)
    w = steering_weights(freqs, steering_delays(geom, [20.0, -40.0]))
    idx = np.sort(rng.integers(0, 2, (b, t)), axis=1)
    src = (rng.standard_normal((t, b, 1, nb))
           + 1j * rng.standard_normal((t, b, 1, nb)))
    noise = (rng.standard_normal((t, b, m, nb))
             + 1j * rng.standard_normal((t, b, m, nb)))
    spec = src * w.numpy()[idx.T] + noise * np.linspace(0.01, 2.0, nb)
    return (torch.as_tensor(spec, dtype=torch.complex64, device=device),
            w.to(torch.complex64).to(device),
            torch.as_tensor(idx, dtype=torch.int64, device=device))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("m", [3, 16])
@pytest.mark.parametrize("row", ["phase_mask", "mpf_march", "mcra_march"])
def test_mask_kernels_take_a_stream_axis(cuda, row, m, b):
    """Rows 7 and 8 and the MCRA march on B streams (T, B, M, NB), from
    carried states whose current_L differ per stream (L = 7: the streams
    roll over at different frames): one launch; each stream equals the same
    kernel on that stream alone bit for bit, output and state; and the
    plain version with the stream axis under the flip contract, current_L
    and first_L exact."""
    from beamform_tpu_torch.config import McraParams, PhasempfParams
    from beamform_tpu_torch.kernels import phase_mask as kpm
    from beamform_tpu_torch.models.batching import stack_states
    from beamform_tpu_torch.models.mcra import freq_smooth
    t, nb = 70, 130
    spec, w, idx = _stream_mask_operands(m, t, nb, b, 40 + m + b, cuda)
    cur = [7, 2, 5][:b]
    if row == "phase_mask":
        fn, plain = kpm.phase_mask, kpm.phase_mask_plain
        args = lambda i: ((spec, w, idx) if i is None else  # noqa: E731
                          (spec[:, i].contiguous(), w, idx[i].contiguous()))
        tail = (0.35, 0.004, 0.1, 2 * (nb - 2))
        states = None
    elif row == "mpf_march":
        fn, plain = kpm.mpf_march, kpm.mpf_march_plain
        p = PhasempfParams(**dict(load_launch_params("phasempf"), MCRA_L=7))
        states = [_carried(kpm.MpfState, lambda st, n, i=i: kpm.mpf_march_plain(
            spec[:n, i].contiguous(), w, idx[i, :n].contiguous(), st, p,
            True)[1], nb, cuda)._replace(current_l=torch.tensor(
                c, dtype=torch.int32, device=cuda))
            for i, c in enumerate(cur)]
        args = lambda i: ((spec, w, idx) if i is None else  # noqa: E731
                          (spec[:, i].contiguous(), w, idx[i].contiguous()))
        tail = (p, True)
    else:
        fn, plain = kpm.mcra_march, kpm.mcra_march_plain
        p = McraParams(**dict(load_launch_params("mcra"), L=7))
        x = spec[:, :, 0].contiguous()
        sq = x.abs() ** 2
        s_f = freq_smooth(sq, x[..., 0].abs())
        states = [_carried(kpm.McraState, lambda st, n, i=i: kpm.mcra_march_plain(
            s_f[:n, i], sq[:n, i], x[:n, i], st, p, False)[1], nb,
            cuda)._replace(current_l=torch.tensor(c, dtype=torch.int32,
                                                  device=cuda))
            for i, c in enumerate(cur)]
        args = lambda i: ((s_f, sq, x) if i is None else  # noqa: E731
                          tuple(a[:, i].contiguous() for a in (s_f, sq, x)))
        tail = (p, False)

    def call(f, i):
        if states is None:
            return f(*args(i), *tail)
        st = stack_states(states) if i is None else states[i]
        return f(*args(i), st, *tail)

    before = fn.launches
    got = call(fn, None)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    y = got if states is None else got[0]
    assert y.shape == (b, t, nb)
    for i in range(b):
        one = call(fn, i)
        if states is None:
            assert torch.equal(y[i], one)
            continue
        assert torch.equal(y[i], one[0])
        for name, a, r in zip(one[1]._fields, got[1], one[1]):
            assert torch.equal(a[i], r), name
    ref = call(plain, None)
    if states is None:
        _assert_close_mod_flips(y, ref)
        return
    _assert_close_mod_flips(y, ref[0])
    assert torch.equal(got[1].current_l.cpu(), ref[1].current_l.cpu())
    assert torch.equal(got[1].first_l.cpu(), ref[1].first_l.cpu())
    if b > 1:
        assert len(set(got[1].current_l.tolist())) > 1
    for a, r in zip(got[1][:-2], ref[1][:-2]):
        _assert_close_mod_flips(a, r)


def test_phase_wrappers_refuse_what_they_do_not_take(cuda):
    from beamform_tpu_torch.config import McraParams, PhasempfParams
    from beamform_tpu_torch.kernels import phase_mask as kpm
    spec, w, idx = _phase_operands(3, 4, 130, 1, 0, cuda)
    mask = (0.35, 0.004, 0.1, 256)
    mp = PhasempfParams()
    st = kpm.init_state(kpm.MpfState, 130, torch.float32, cuda)
    counts = (kpm.phase_mask.launches, kpm.mpf_march.launches,
              kpm.mcra_march.launches)
    for bad, match in (
            ((spec.cdouble(), w.cdouble(), idx), "takes torch.complex64"),
            ((spec, w[:, :2].contiguous(), idx), "shape"),
            ((spec, w.cpu(), idx), "is on cpu"),
            ((spec, w.conj(), idx), "conjugate"),
            ((spec, w, idx.int()), "takes torch.int64"),
            ((spec.transpose(0, 1).contiguous().transpose(0, 1), w, idx),
             "contiguous"),
            ((spec[:, :1].contiguous(), w[:, :1].contiguous(), idx),
             "2 to 32 mics")):
        with pytest.raises(ValueError, match=match):
            kpm.phase_mask(*bad, *mask)
        with pytest.raises(ValueError, match=match):
            kpm.mpf_march(*bad, st, mp, True)
    with pytest.raises(ValueError, match="shape"):
        kpm.mpf_march(spec, w, idx, kpm.init_state(
            kpm.MpfState, 129, torch.float32, cuda), mp, True)
    x = spec[:, 0].contiguous()
    sq = x.abs() ** 2
    mst = kpm.init_state(kpm.McraState, 130, torch.float32, cuda)
    for bad, match in (((sq, sq, x.conj()), "conjugate"),
                       ((sq.double(), sq, x), "takes torch.float32"),
                       ((sq, sq[:, :5], x), "shape")):
        with pytest.raises(ValueError, match=match):
            kpm.mcra_march(*bad, mst, McraParams(), True)
    assert counts == (kpm.phase_mask.launches, kpm.mpf_march.launches,
                      kpm.mcra_march.launches)


def _source_scene(cfg, seconds, hop, theta=20.0, seed=5):
    """A far-field source at ``theta`` (its delays applied exactly in the
    frequency domain) under a syllabic envelope, plus weak noise."""
    from beamform_tpu_torch.geometry import ArrayGeometry, steering_delays
    rng = np.random.default_rng(seed)
    n = int(seconds * 48000) // hop * hop
    tau = steering_delays(ArrayGeometry.from_config(cfg), theta).numpy()
    f = np.fft.rfftfreq(n, 1.0 / 48000)
    s = np.fft.rfft(rng.standard_normal(n))
    x = np.fft.irfft(s[None] * np.exp(-2j * np.pi * f[None] * tau[:, None]),
                     n=n)
    env = np.clip(np.sin(2 * np.pi * 3.7 * np.arange(n) / 48000) + 0.2, 0,
                  1)
    x = 3.0 * x * env + 0.05 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


@pytest.mark.parametrize("node", ["phase", "phasempf", "mcra"])
def test_phase_nodes_on_cuda_match_float64_cpu(cuda, node):
    """16 mics at hop 128 and 1024 under the launch presets: the card's
    float32 output against the float64 CPU path under the mask contract,
    each path's exact launches, and chunks equal to one offline call."""
    from beamform_tpu_torch.kernels import phase_mask as kpm
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    counters = (kw.wola_analysis, kw.wola_synthesis, km.mvdr_stream,
                klc.lcmv_stream, kl.gj_inverse, kmega.mega_stream,
                kgss.gss_mega, kpm.phase_mask, kpm.mpf_march, kpm.mcra_march)
    expect = {"phase": 7, "phasempf": 8, "mcra": 9}[node]
    for hop in (128, 1024):
        x = _source_scene(cfg, 1.0, hop)
        t = x.shape[1] // hop
        th = np.full(t, 20.0)
        th[t // 2:] = -35.0
        eng = EngineConfig(window_size=hop)
        model = get_model(node, eng, cfg, load_launch_params(node),
                          device=cuda)
        before = [f.launches for f in counters]
        got = model.process(x, th)
        ran = [f.launches - b for f, b in zip(counters, before)]
        assert ran == [1, 1] + [int(i == expect) for i in range(2, 10)]
        ref = run_offline(node, x, engine=EngineConfig(window_size=hop,
                                                        dtype="float64"),
                          array_cfg=cfg, theta=th,
                          params=load_launch_params(node), device="cpu")
        assert np.isfinite(got.cpu().numpy()).all()
        _assert_close_mod_flips(got, ref)
        sess = StreamingSession(model)
        chunks = [sess.process(x[:, f0 * hop:(f0 + 5) * hop], th[f0:f0 + 5])
                  for f0 in range(0, t, 5)]
        assert torch.equal(torch.cat(chunks)[:got.shape[0]], got)


# ---------------------------------------------------------------------------
# GSC: the per-sample kernel (and its xmu mode) and the block-LMS kernel
# ---------------------------------------------------------------------------


def _gsc_operands(b, m, s, seed, device, dtype=torch.float32):
    """Aligned audio (B, M, S) and a carried state: registers and recent
    outputs of the same scale as the audio, filters small and non-zero."""
    rng = np.random.default_rng(seed)

    def t(shape, scale):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=dtype, device=device)

    return (t((b, m, s), 0.2), t((b, m - 1, 128), 0.2),
            t((b, m - 1, 128), 0.01), t((b, 128), 0.1))


def _gsc_params(**kw):
    from beamform_tpu_torch.config import GscParams
    return GscParams(**dict(dict(mu0=0.0005, mu_max=0.05, filter_size=128,
                                 vad_threshold=0.05), **kw))


def _dev64(got, ref64):
    return float((got.double() - ref64.double()).abs().max())


@pytest.mark.parametrize("m", [2, 3, 4, 9, 16])
@pytest.mark.parametrize("use_vad", [False, True])
@pytest.mark.parametrize("xmu", [False, True])
def test_gsc_sample_kernel_matches_plain(cuda, m, use_vad, xmu):
    """Rows 9 and 10 against the plain recurrence from a carried state,
    two streams: the JAX package's kernel-vs-scan tolerance
    (tests/test_gsc_pallas.py), and the kernel no further from float64
    than twice the plain float32 version plus that tolerance. M = 2 leaves
    two of the kernel's workers without a channel; M = 9 half fills one."""
    from beamform_tpu_torch.kernels import gsc as kg
    ops = _gsc_operands(2, m, 1024, m + 7 * use_vad, cuda)
    p = _gsc_params(use_vad=use_vad)
    fn = kg.gsc_xmu if xmu else kg.gsc_sample
    before = fn.launches
    got = fn(*ops, p)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = kg.gsc_sample_plain(*ops, p)
    ref64 = kg.gsc_sample_plain(*(o.double() for o in ops), p)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, r, atol=2e-5, rtol=1e-4)
    assert torch.equal(got[1], ref[1])               # the registers
    assert _dev64(got[0], ref64[0]) <= 2 * _dev64(ref[0], ref64[0]) + 2e-5


@pytest.mark.parametrize("xmu", [False, True])
@pytest.mark.parametrize("where", [128 + 7, 256])
def test_gsc_sample_kernel_nan_at_group_and_tile_edges(cuda, xmu, where):
    """A NaN input sample at a group's last sample (the next group's base
    dots were formed before it was met) and at a tile's first sample (the
    pipeline's restart): NaN outputs exactly where the plain recurrence
    has them, the taps scrubbed, the rest within the matches_plain
    tolerance; the kernel replayed groups, and ran the rest factorised."""
    from beamform_tpu_torch.kernels import gsc as kg
    a, blk, flt, lo = _gsc_operands(1, 16, 1024, 21, cuda)
    a[0, 5, where] = float("nan")
    p = _gsc_params()
    fn = kg.gsc_xmu if xmu else kg.gsc_sample
    before = kg.gsc_sample.group_counts()
    got = fn(a, blk, flt, lo, p)
    after = kg.gsc_sample.group_counts()
    ref = kg.gsc_sample_plain(a, blk, flt, lo, p)
    nan = torch.isnan(got[0])
    assert bool(nan[0, where]) and torch.equal(nan, torch.isnan(ref[0]))
    assert not torch.isnan(got[2]).any()
    torch.testing.assert_close(got[0][~nan], ref[0][~nan], atol=2e-5,
                               rtol=1e-4)
    torch.testing.assert_close(got[2], ref[2], atol=2e-5, rtol=1e-4)
    replayed, fact = after[1] - before[1], after[0] - before[0]
    assert replayed > 0 and fact > 0 and replayed + fact == 1024 // 8


@pytest.mark.parametrize("mu0", [1e20, 1e30])
def test_gsc_sample_kernel_diverging_filter(cuda, mu0):
    """A step so large that the filters overflow: every third output is
    NaN and the update scrubs the taps (mu0 = 1e20: they end at 0; 1e30:
    at +-inf, which no scrub touches). The kernel's NaN positions and
    final taps equal the plain recurrence's; this is where the lookahead
    route (row 12, a scrub once a group) departs from it."""
    from beamform_tpu_torch.kernels import gsc as kg
    ops = _gsc_operands(1, 4, 512, 9, cuda)
    p = _gsc_params(mu0=mu0, mu_max=mu0)
    ref = kg.gsc_sample_plain(*ops, p)
    for fn in (kg.gsc_sample, kg.gsc_xmu):
        got = fn(*ops, p)
        torch.cuda.synchronize()
        nan = torch.isnan(got[0])
        assert nan.any() and torch.equal(nan, torch.isnan(ref[0]))
        assert torch.equal(got[2] == 0, ref[2] == 0)
        assert torch.equal(torch.isinf(got[2]), torch.isinf(ref[2]))
        assert torch.equal(torch.isnan(got[2]), torch.isnan(ref[2]))
        fin = torch.isfinite(ref[2])
        torch.testing.assert_close(got[2][fin], ref[2][fin], atol=2e-5,
                                   rtol=1e-3)


def test_gsc_sample_kernel_group_counts(cuda):
    """group_counts() grows by one factorised group per 8 samples of each
    stream on finite input, with no replay, and the launch count by one."""
    from beamform_tpu_torch.kernels import gsc as kg
    ops = _gsc_operands(3, 16, 1024, 4, cuda)
    for fn in (kg.gsc_sample, kg.gsc_xmu):
        before, launches = kg.gsc_sample.group_counts(), fn.launches
        fn(*ops, _gsc_params())
        after = kg.gsc_sample.group_counts()
        assert fn.launches == launches + 1
        assert (after[0] - before[0], after[1] - before[1]) == (3 * 128, 0)


def test_gsc_sample_kernel_chunks_equal_one_call(cuda):
    """Fresh power sums and tiles at the same offsets: two calls of 512
    samples give one call of 1024 bit for bit, trace included."""
    from beamform_tpu_torch.kernels import gsc as kg
    a, blk, flt, lo = _gsc_operands(3, 16, 1024, 5, cuda)
    p = _gsc_params(use_vad=True, vad_threshold=0.05)
    full = kg.gsc_sample(a, blk, flt, lo, p, with_mu=True)
    one = kg.gsc_sample(a[..., :512].contiguous(), blk, flt, lo, p,
                        with_mu=True)
    two = kg.gsc_sample(a[..., 512:].contiguous(), *one[1:4], p,
                        with_mu=True)
    assert torch.equal(torch.cat([one[0], two[0]], -1), full[0])
    for x, y in zip(two[1:4], full[1:4]):
        assert torch.equal(x, y)
    assert torch.equal(torch.cat([one[4][0], two[4][0]], -1), full[4][0])
    assert torch.equal(torch.cat([one[4][1], two[4][1]], -1), full[4][1])


@pytest.mark.parametrize("xmu", [False, True])
def test_gsc_sample_kernel_30s_equals_chunks(cuda, xmu):
    """30 s at 48 kHz (1,407 hops of 1,024, one stream, 16 mics) in one
    call equals the same input in chunks of uneven multiples of 128
    samples, bit for bit, state and trace included."""
    from beamform_tpu_torch.kernels import gsc as kg
    a, blk, flt, lo = _gsc_operands(1, 16, 1407 * 1024, 11, cuda)
    p = _gsc_params(use_vad=True)
    fn = kg.gsc_xmu if xmu else kg.gsc_sample
    full = fn(a, blk, flt, lo, p, with_mu=True)
    outs, mus, st = [], [], (blk, flt, lo)
    edges = [0, 128, 128 * 1001, 128 * 1038, 128 * 7000, a.shape[-1]]
    for e0, e1 in zip(edges[:-1], edges[1:]):
        res = fn(a[..., e0:e1].contiguous(), *st, p, with_mu=True)
        outs.append(res[0])
        mus.append(res[4][0])
        st = res[1:4]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, -1), full[0])
    assert torch.equal(torch.cat(mus, -1), full[4][0])
    for x, y in zip(st, full[1:4]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("use_vad", [False, True])
def test_gsc_sample_kernel_mu_trace(cuda, use_vad):
    """The mu trace (channel 0's step, the update flag) against the plain
    recurrence's; the VAD threshold gates about half the samples."""
    from beamform_tpu_torch.kernels import gsc as kg
    ops = _gsc_operands(1, 16, 1024, 3, cuda)
    # the threshold at the median power of the ungated run's outputs
    free = kg.gsc_sample_plain(*ops, _gsc_params())[0]
    level = float(torch.sqrt(kg.window_sums(free * free, 128) / 128).median())
    p = _gsc_params(use_vad=use_vad, vad_threshold=level)
    got = kg.gsc_sample(*ops, p, with_mu=True)
    ref = kg.gsc_sample_plain(*ops, p, with_mu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[4][0], ref[4][0], atol=1e-7, rtol=1e-4)
    assert got[4][1].dtype == torch.bool
    assert torch.equal(got[4][1], ref[4][1])
    if use_vad:
        assert 0 < int(got[4][1].sum()) < got[4][1].numel()


def test_gsc_sample_kernel_cold_start_and_nan(cuda):
    """From a zero state (osq = 0 over the first outputs, every step 0
    until the registers fill) and with a NaN sample mid-stream: the
    kernel's NaN and zero handling against the plain recurrence's."""
    from beamform_tpu_torch.kernels import gsc as kg
    a, blk, flt, lo = _gsc_operands(1, 4, 512, 9, cuda)
    zero = [torch.zeros_like(t) for t in (blk, flt, lo)]
    p = _gsc_params()
    got = kg.gsc_sample(a, *zero, p)
    ref = kg.gsc_sample_plain(a, *zero, p)
    torch.testing.assert_close(got[0], ref[0], atol=2e-5, rtol=1e-4)
    bad = a.clone()
    bad[0, 1, 300] = float("nan")
    got = kg.gsc_sample(bad, blk, flt, lo, p)
    ref = kg.gsc_sample_plain(bad, blk, flt, lo, p)
    torch.cuda.synchronize()
    assert not torch.isnan(got[2]).any()             # the taps scrubbed
    torch.testing.assert_close(got[0][:, :300], ref[0][:, :300], atol=2e-5,
                               rtol=1e-4)
    assert torch.isnan(got[0][0, 300])


def test_gsc_sample_kernel_silent_lead_in_and_nan(cuda):
    """The counterpart of test_gsc_block_kernel_cold_start_and_nan for the
    per-sample kernel and its xmu mode: from a zero state behind a silent
    lead-in every power is exactly 0 and every step scrubbed to 0, so the
    output is zeros, not NaN; then a NaN sample mid-stream gives NaN
    outputs exactly where the plain version has them, and the taps are
    scrubbed."""
    from beamform_tpu_torch.kernels import gsc as kg
    a, blk, flt, lo = _gsc_operands(1, 4, 512, 9, cuda)
    a[..., :256] = 0.0
    zero = [torch.zeros_like(t) for t in (blk, flt, lo)]
    p = _gsc_params()
    ref = kg.gsc_sample_plain(a, *zero, p, with_mu=True)
    for fn in (kg.gsc_sample, kg.gsc_xmu):
        got = fn(a, *zero, p, with_mu=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0][:, :256], torch.zeros_like(got[0][:, :256]))
        assert torch.equal(got[4][0][:, :256], ref[4][0][:, :256])
        torch.testing.assert_close(got[0], ref[0], atol=2e-5, rtol=1e-4)
    bad = a.clone()
    bad[0, 1, 300] = float("nan")
    ref = kg.gsc_sample_plain(bad, blk, flt, lo, p)
    for fn in (kg.gsc_sample, kg.gsc_xmu):
        got = fn(bad, blk, flt, lo, p)
        torch.cuda.synchronize()
        assert not torch.isnan(got[2]).any()         # the taps scrubbed
        nan = torch.isnan(got[0])
        assert bool(nan[0, 300]) and torch.equal(nan, torch.isnan(ref[0]))
        torch.testing.assert_close(got[0][~nan], ref[0][~nan], atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("l", [128, 256, 512, 1024])
@pytest.mark.parametrize("m", [2, 5, 16])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("use_vad", [False, True])
def test_gsc_blocklms_kernel_matches_plain(cuda, l, m, b, use_vad):
    """Row 11 against its plain version from a carried state, at the JAX
    package's kernel-vs-scan tolerance (tests/test_gsc_blocklms.py): every
    block length, one and two channels a CTA (clusters of 1, 4 and 8 CTAs,
    kernels/gsc_blocklms.py cluster_plan), one and three streams."""
    from beamform_tpu_torch.kernels import gsc_blocklms as kb
    ops = _gsc_operands(b, m, 2048, l + m + 100 * b, cuda)
    p = _gsc_params(use_vad=use_vad, mu_max=0.01, solver="blocklms",
                    block_samples=l)
    before = kb.gsc_blocklms.launches
    got = kb.gsc_blocklms(*ops, p)
    torch.cuda.synchronize()
    assert kb.gsc_blocklms.launches == before + 1
    ref = kb.gsc_blocklms_plain(*ops, p)
    torch.testing.assert_close(got[0], ref[0], atol=5e-6, rtol=1e-4)
    torch.testing.assert_close(got[2], ref[2], atol=2e-6, rtol=1e-4)
    assert torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[3], ref[3], atol=5e-6, rtol=1e-4)
    one = kb.gsc_blocklms(*(o[..., :1024].contiguous() if i == 0 else o
                            for i, o in enumerate(ops)), p)
    two = kb.gsc_blocklms(ops[0][..., 1024:].contiguous(), *one[1:], p)
    assert torch.equal(torch.cat([one[0], two[0]], -1), got[0])
    assert torch.equal(two[2], got[2])


def _vad_boundary_operands(b, m, s, seed, device):
    """Operands whose osq is exactly 32 at every sample while the filters
    stay 0: every mic is +-0.5 (one sign a sample) plus dyadic offsets
    that cancel in the mic sum, so the fixed beam is exactly +-0.5 for M a
    power of two, and the last outputs are +-0.5 too; with zero filters
    each output is the beam, so each window's 128 squares sum to 32 in any
    order. sqrt(32 / 128) = 0.5 is where the VAD test flips."""
    rng = np.random.default_rng(seed)
    sign = rng.choice([-0.5, 0.5], size=(b, 1, s))
    off = np.zeros((b, m, s))
    delta = rng.choice([-0.25, -0.125, 0.125, 0.25], size=(b, m // 2, s))
    off[:, 0:2 * (m // 2):2] = delta
    off[:, 1:2 * (m // 2):2] = -delta
    a = torch.as_tensor(sign + off, dtype=torch.float32, device=device)
    blk = torch.as_tensor(0.2 * rng.standard_normal((b, m - 1, 128)),
                          dtype=torch.float32, device=device)
    lo = torch.as_tensor(rng.choice([-0.5, 0.5], size=(b, 128)),
                         dtype=torch.float32, device=device)
    return a, blk, torch.zeros_like(blk), lo


@pytest.mark.parametrize("kernel", ["sample", "blocklms", "block"])
@pytest.mark.parametrize("m", [4, 16])
def test_gsc_kernels_vad_threshold_on_a_float32_boundary(cuda, kernel, m):
    """The kernels test osq against a host threshold
    (kernels/gsc.py vad_power_threshold) where the plain versions take
    sqrt(osq / K) < vad_threshold. With osq exactly 32 everywhere and the
    threshold exactly sqrt(32 / 128) = 0.5, the gate holds at every
    sample: the output is the beam bit for bit and the filters stay 0.
    One float32 above 0.5, the gate opens in both the kernel and its plain
    version, which then agree as in the *_matches_plain tests: the large
    step moves osq off the boundary once the filters adapt (on these
    operands at least 6e-4 from it afterwards, where float32 round-off is
    ~1e-5), so no later decision rests on round-off."""
    from beamform_tpu_torch.kernels import gsc as kg
    from beamform_tpu_torch.kernels import gsc_block as kbk
    from beamform_tpu_torch.kernels import gsc_blocklms as kb
    from beamform_tpu_torch.models.gsc import gram_refresh
    a, blk, flt, lo = _vad_boundary_operands(2, m, 1024, m, cuda)
    if kernel == "block":
        uold = torch.zeros_like(blk[..., :8])
        gram, _ = gram_refresh(uold[..., :0], uold, blk, 128)
        st = (blk, flt, lo, gram.contiguous(), uold)
        fn, plain = kbk.gsc_block, kbk.gsc_block_plain
    else:
        st = (blk, flt, lo)
        fn, plain = {"sample": (kg.gsc_sample, kg.gsc_sample_plain),
                     "blocklms": (kb.gsc_blocklms,
                                  kb.gsc_blocklms_plain)}[kernel]
    beam = a.mean(dim=1)
    edge = float(np.sqrt(np.float32(32.0) / np.float32(128.0)))
    assert edge == 0.5
    above = float(np.nextafter(np.float32(edge), np.float32(1.0)))
    for vad, holds in ((edge, True), (above, False)):
        p = _gsc_params(use_vad=True, vad_threshold=vad, solver=kernel,
                        mu0=0.02)
        got = fn(a, *st, p)
        ref = plain(a, *st, p)
        torch.cuda.synchronize()
        assert torch.equal(ref[0], beam) == holds
        assert torch.equal(got[0], beam) == holds
        assert torch.equal(got[2], flt) == holds
        if not holds:
            torch.testing.assert_close(got[0], ref[0], atol=3e-5, rtol=1e-4)
            torch.testing.assert_close(got[2], ref[2], atol=2e-5, rtol=1e-3)


def _block_operands(b, m, s, seed, device):
    """_gsc_operands plus the block kernel's gram (as gram_refresh writes
    it) and uold, the 8 samples before the registers."""
    from beamform_tpu_torch.models.gsc import gram_refresh
    a, blk, flt, lo = _gsc_operands(b, m, s, seed, device)
    rng = np.random.default_rng(seed + 100)
    uold = torch.as_tensor(0.2 * rng.standard_normal((b, m - 1, 8)),
                           dtype=torch.float32, device=device)
    gram, _ = gram_refresh(uold[..., :0], uold, blk, 128)
    return a, blk, flt, lo, gram.contiguous(), uold


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("use_vad", [False, True])
def test_gsc_block_kernel_matches_plain(cuda, m, use_vad):
    """Row 12 against its plain version from a carried state, two streams:
    the JAX package's block-vs-scan tolerances (tests/test_gsc_block.py),
    and the kernel no further from the plain version in float64 than twice
    the plain float32 version plus the sample kernel's slack."""
    from beamform_tpu_torch.kernels import gsc_block as kbk
    ops = _block_operands(2, m, 1024, 3 * m + use_vad, cuda)
    p = _gsc_params(use_vad=use_vad, solver="block")
    before = kbk.gsc_block.launches
    got = kbk.gsc_block(*ops, p)
    torch.cuda.synchronize()
    assert kbk.gsc_block.launches == before + 1
    ref = kbk.gsc_block_plain(*ops, p)
    ref64 = kbk.gsc_block_plain(*(o.double() for o in ops), p)
    scale = float(ref64[0].abs().max())
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.isfinite(g).all()
    torch.testing.assert_close(got[0], ref[0], atol=3e-5 * scale, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=2e-5, rtol=1e-3)
    torch.testing.assert_close(got[3], ref[3], atol=3e-5 * scale, rtol=0)
    torch.testing.assert_close(got[4], ref[4], atol=2e-4, rtol=2e-3)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[5], ref[5])
    assert _dev64(got[0], ref64[0]) <= 2 * _dev64(ref[0], ref64[0]) + 2e-5


def test_gsc_block_kernel_chunks_equal_one_call(cuda):
    """Fresh Grams and powers, groups and tiles at the same offsets: two
    calls of 512 samples give one call of 1024 bit for bit, state too."""
    from beamform_tpu_torch.kernels import gsc_block as kbk
    a, *st = _block_operands(3, 16, 1024, 5, cuda)
    p = _gsc_params(use_vad=True, solver="block")
    full = kbk.gsc_block(a, *st, p)
    one = kbk.gsc_block(a[..., :512].contiguous(), *st, p)
    two = kbk.gsc_block(a[..., 512:].contiguous(), *one[1:], p)
    assert torch.equal(torch.cat([one[0], two[0]], -1), full[0])
    for x, y in zip(two[1:], full[1:]):
        assert torch.equal(x, y)


def test_gsc_block_kernel_cold_start_and_nan(cuda):
    """From a zero state behind a silent lead-in (every power 0, every
    step scrubbed to 0: zeros out, not NaN), then with a NaN sample
    mid-stream: NaN outputs exactly where the plain version has them,
    the taps scrubbed at the group's end."""
    from beamform_tpu_torch.kernels import gsc_block as kbk
    a, *st = _block_operands(1, 4, 512, 9, cuda)
    a[..., :256] = 0.0
    zero = [torch.zeros_like(t) for t in st]
    p = _gsc_params(solver="block")
    got = kbk.gsc_block(a, *zero, p)
    ref = kbk.gsc_block_plain(a, *zero, p)
    assert torch.equal(got[0][:, :256], torch.zeros_like(got[0][:, :256]))
    torch.testing.assert_close(got[0], ref[0], atol=2e-5, rtol=1e-4)
    bad = a.clone()
    bad[0, 1, 300] = float("nan")
    got = kbk.gsc_block(bad, *st, p)
    ref = kbk.gsc_block_plain(bad, *st, p)
    torch.cuda.synchronize()
    assert not torch.isnan(got[2]).any()             # the taps scrubbed
    nan = torch.isnan(got[0])
    assert bool(nan[0, 300]) and torch.equal(nan, torch.isnan(ref[0]))
    torch.testing.assert_close(got[0][~nan], ref[0][~nan], atol=2e-5,
                               rtol=1e-4)


def test_gsc_kernels_raise_on_what_they_do_not_take(cuda):
    from beamform_tpu_torch.kernels import gsc as kg
    from beamform_tpu_torch.kernels import gsc_blocklms as kb
    a, blk, flt, lo = _gsc_operands(1, 4, 256, 0, cuda)
    p = _gsc_params()
    with pytest.raises(ValueError, match="filter_size"):
        kg.gsc_sample(a, blk[..., :64].contiguous(),
                      flt[..., :64].contiguous(), lo[..., :64].contiguous(),
                      p)
    with pytest.raises(ValueError, match="float32"):
        kg.gsc_sample(a.double(), blk.double(), flt.double(), lo.double(), p)
    with pytest.raises(ValueError, match="float32"):
        kg.gsc_xmu(a.double(), blk.double(), flt.double(), lo.double(), p)
    with pytest.raises(ValueError, match="multiple of 128"):
        kg.gsc_sample(a[..., :200].contiguous(), blk, flt, lo, p)
    big = _gsc_operands(1, 17, 256, 0, cuda)
    with pytest.raises(ValueError, match="16 mics"):
        kg.gsc_sample(*big, p)
    with pytest.raises(ValueError, match="block_samples"):
        kb.gsc_blocklms(a, blk, flt, lo,
                        _gsc_params(solver="blocklms", block_samples=512))
    from beamform_tpu_torch.kernels import gsc_block as kbk
    ops = _block_operands(1, 4, 256, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        kbk.gsc_block(*(o.double() for o in ops), p)
    with pytest.raises(ValueError, match="multiple of 128"):
        kbk.gsc_block(ops[0][..., :200].contiguous(), *ops[1:], p)
    with pytest.raises(ValueError, match="16 mics"):
        kbk.gsc_block(*_block_operands(1, 17, 256, 0, cuda), p)


def _gsc_model(cuda, dtype="float32", **kw):
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    return get_model("gsc", EngineConfig(dtype=dtype), cfg,
                     {**load_launch_params("gsc"), "write_mu": False, **kw},
                     device=cuda), cfg


def test_gsc_model_raises_on_cuda(cuda):
    """K != 128 and float64 raise on the card, for every solver, never a
    quiet plain loop."""
    x = np.zeros((16, 2048), np.float32)
    for solver in ("sample", "block"):
        with pytest.raises(ValueError, match="filter_size"):
            _gsc_model(cuda, filter_size=64, solver=solver)[0].process(
                x, 20.0)
    with pytest.raises(ValueError, match="float32"):
        _gsc_model(cuda, dtype="float64")[0].process(x, 20.0)


@pytest.mark.parametrize("solver", ["sample", "xmu", "blocklms", "block",
                                    "write_mu"])
def test_gsc_on_cuda_matches_float64_cpu(cuda, solver, tmp_path):
    """16 mics, 1 s under the launch preset: the card's float32 output
    against the float64 CPU path within 1e-3, each path's own launches,
    and chunks equal to one offline call."""
    from beamform_tpu_torch.kernels import gsc as kg
    from beamform_tpu_torch.kernels import gsc_block as kbk
    from beamform_tpu_torch.kernels import gsc_blocklms as kb
    over = ({"write_mu": True} if solver == "write_mu"
            else {"solver": solver})
    model, cfg = _gsc_model(cuda, **over)
    model.mu_file_path = str(tmp_path / "mu.txt")
    rng = np.random.default_rng(4)
    x = (0.1 * rng.standard_normal((16, 48 * 1024))).astype(np.float32)
    fns = (kg.gsc_sample, kg.gsc_xmu, kb.gsc_blocklms, kbk.gsc_block,
           kw.wola_analysis, kw.wola_synthesis)
    before = [f.launches for f in fns]
    got = model.process(x, 20.0).cpu().numpy()
    ran = [f.launches - b for f, b in zip(fns, before)]
    which = {"sample": 0, "write_mu": 0, "xmu": 1, "blocklms": 2,
             "block": 3}[solver]
    assert ran == [int(i == which) for i in range(4)] + [1, 1]
    # the same solver without the trace file (write_mu leaves the output
    # as it is)
    ref = run_offline("gsc", x, engine=EngineConfig(dtype="float64"),
                      array_cfg=cfg, theta=20.0,
                      params={**load_launch_params("gsc"), **over,
                              "write_mu": False},
                      device="cpu")
    assert np.isfinite(got).all() and np.abs(got - ref).max() <= 1e-3
    if solver == "write_mu":
        assert len(open(model.mu_file_path).read().splitlines()) == 48
    sess = StreamingSession(model)
    chunks = [sess.process(x[:, f0 * 1024:(f0 + 8) * 1024], 20.0)
              for f0 in range(0, 48, 8)]
    assert np.array_equal(torch.cat(chunks).cpu().numpy(), got)


# ------------------------------------------------- stream axis, rows 3-6

NB16 = 3           # streams of the stream-axis cases


def _preset_band(cuda):
    """The launch presets' band (100 Hz .. 16 kHz) at 48 kHz, hop 1024:
    bins 5 .. 682."""
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    return get_model("mvdr", EngineConfig(), cfg, load_launch_params("mvdr"),
                     device=cuda).ib


@pytest.mark.parametrize("row,s", [("mvdr", 0), ("lcmv", 1), ("lcmv", 3)])
def test_stream_kernels_take_a_stream_axis(cuda, row, s):
    """Rows 3 and 5 at three streams of 16 mics over the presets' band: one
    launch; each stream equals the same kernel on that stream alone bit for
    bit, and the batched plain version within MVDR_REL."""
    rng = np.random.default_rng(300 + s)
    ib = _preset_band(cuda)
    t, m, nb, w, u, nib = 45, 16, 1026, 10, 2, len(ib)
    x = _cplx(rng, (t, NB16, m, nb), cuda)
    hist = _cplx(rng, (NB16, w, m, nib), cuda)
    idx = torch.as_tensor(rng.integers(0, u, (NB16, t)), device=cuda)
    gate = torch.as_tensor(rng.random((NB16, t, nib)) < 0.7, device=cuda)
    if row == "mvdr":
        fn, plain, ctrl = (km.mvdr_stream, km.mvdr_stream_plain,
                           _cplx(rng, (u, m, nib), cuda))
    else:
        fn, plain, ctrl = (klc.lcmv_stream, klc.lcmv_stream_plain,
                           _constraints(rng, u, s, m, nib, cuda))
    before = fn.launches
    got = fn(x, hist, ctrl, idx, gate, ib)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == (NB16, t, nib)
    assert torch.isfinite(torch.view_as_real(got)).all()
    for b in range(NB16):
        one = fn(x[:, b].contiguous(), hist[b], ctrl, idx[b].contiguous(),
                 gate[b].contiguous(), ib)
        assert torch.equal(got[b], one)
    ref = plain(*(a.cpu() for a in (x, hist, ctrl, idx, gate, ib)))
    assert _rel(got.cpu(), ref) < MVDR_REL


@pytest.mark.parametrize("row,s", [("mvdr", 0), ("lcmv", 3)])
@pytest.mark.parametrize("groups", [2, 4])
def test_stream_kernels_on_bin_groups_equal_one_launch(cuda, row, s,
                                                       groups):
    """Rows 3 and 5 on the presets' band cut into bin groups, as the
    sharded MVDR/LCMV step (parallel/sharded.py) runs them on each rank:
    each group's launch (its bins, history, steering and gate, the last
    group padded by repeating the band's last bin) equals the same lanes
    of one launch over the whole band, bit for bit, three streams."""
    rng = np.random.default_rng(400 + s + groups)
    ib = _preset_band(cuda)
    t, m, nb, w, u, nib = 45, 16, 1026, 10, 2, len(ib)
    x = _cplx(rng, (t, NB16, m, nb), cuda)
    hist = _cplx(rng, (NB16, w, m, nib), cuda)
    idx = torch.as_tensor(rng.integers(0, u, (NB16, t)), device=cuda)
    gate = torch.as_tensor(rng.random((NB16, t, nib)) < 0.7, device=cuda)
    if row == "mvdr":
        fn, ctrl = km.mvdr_stream, _cplx(rng, (u, m, nib), cuda)
    else:
        fn, ctrl = klc.lcmv_stream, _constraints(rng, u, s, m, nib, cuda)
    full = fn(x, hist, ctrl, idx, gate, ib)
    per = -(-nib // groups)
    pos = np.concatenate([np.arange(nib), np.full(per * groups - nib,
                                                  nib - 1)])
    for g in range(groups):
        sel = torch.as_tensor(pos[g * per:(g + 1) * per], device=cuda)
        before = fn.launches
        got = fn(x, hist.index_select(3, sel).contiguous(),
                 ctrl.index_select(ctrl.dim() - 1, sel).contiguous(), idx,
                 gate.index_select(2, sel).contiguous(),
                 ib.index_select(0, sel))
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(got, full.index_select(2, sel)), (row, g)


def _fused_batch_inputs(rng, b, m, t, hop, ib):
    """B streams of audio with quiet hops, their carries, and a gate
    threshold in the widest gap of the pooled statistic near its median
    (a mixed gate that no rounding flips)."""
    x = 0.1 * rng.standard_normal((b, m, t * hop))
    x[:, :, 3 * hop:6 * hop] *= 1e-4
    tail = 0.1 * rng.standard_normal((b, m, hop))
    prev = rng.standard_normal((b, hop))
    x, tail, prev = (torch.as_tensor(a, dtype=torch.float32, device=ib.device)
                     for a in (x, tail, prev))
    mag = torch.stack([kw.wola_analysis_plain(x[i], tail[i],
                                              with_mag=True)[1]
                       for i in range(b)])
    v = mag.index_select(2, ib).flatten().sort().values.cpu().numpy()
    k = len(v) * 2 // 5 + np.argmax(np.diff(v[len(v) * 2 // 5:
                                                len(v) * 3 // 5]))
    return x, tail, prev, float((v[k] + v[k + 1]) / 2)


def _peak_rel(got, ref):
    """Per stream, max |got - ref| over the stream's peak."""
    return max(float((g - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref))


@pytest.mark.parametrize("b", [NB16, 8])
@pytest.mark.parametrize("s", [0, 1, 3])
def test_mega_kernel_takes_a_stream_axis(cuda, b, s):
    """Row 4 at three and eight streams of 16 mics over the presets' band,
    two segments of frames: one launch; each stream within 1e-6 of its
    peak of the same kernel on that stream alone (the overlap-add adds
    with atomics), its history and carry bit for bit; and the batched
    plain version within test_mega_kernel_matches_plain's bar."""
    rng = np.random.default_rng(400 + 10 * b + s)
    ib = _preset_band(cuda)
    hop, t, m, w, u, nib = 1024, 120, 16, 10, 2, len(ib)
    x, tail, prev, thr = _fused_batch_inputs(rng, b, m, t, hop, ib)
    hist = _cplx(rng, (b, w, m, nib), cuda)
    idx = torch.as_tensor(rng.integers(0, u, (b, t)), device=cuda)
    if s == 0:
        ctrl, fused = _cplx(rng, (u, m, nib), cuda), kmega.mvdr_mega
    else:
        ctrl, fused = _constraints(rng, u, s, m, nib, cuda), kmega.lcmv_mega
    before = kmega.mega_stream.launches
    got = fused(x, tail, prev, hist, ctrl, idx, ib, 2 * hop, w, thr)
    torch.cuda.synchronize()
    assert kmega.mega_stream.launches == before + 1
    assert got[0].shape == (b, t * hop) and torch.isfinite(got[0]).all()
    ones = [fused(x[i], tail[i], prev[i], hist[i], ctrl, idx[i], ib,
                  2 * hop, w, thr) for i in range(b)]
    assert _peak_rel(got[0], [o[0] for o in ones]) <= 1e-6
    for i, o in enumerate(ones):
        assert torch.equal(got[1][i], o[1]) and torch.equal(got[2][i], o[2])
    if b == NB16:
        ref = fused(*(a.cpu() for a in (x, tail, prev, hist, ctrl, idx, ib)),
                    2 * hop, w, thr)
        assert _rel(got[0].cpu(), ref[0]) < MVDR_REL
        assert _rel(got[1].cpu(), ref[1]) < REL


@pytest.mark.parametrize("b", [NB16, 8])
@pytest.mark.parametrize("s", [1, 3])
def test_gss_kernel_takes_a_stream_axis(cuda, b, s):
    """Row 6 at three and eight streams of 16 mics over the presets' band
    (eight streams' 5,424 (stream, bin) pairs take the marching blocks two
    passes), two segments of frames, resets per stream: one launch; each
    stream within 1e-6 of its peak of the same kernel on that stream
    alone, W and the carry bit for bit; and the batched plain version
    within test_gss_kernel_matches_plain's bar."""
    rng = np.random.default_rng(500 + 10 * b + s)
    ib = _preset_band(cuda)
    hop, t, m, u, nib = 1024, 120, 16, 2, len(ib)
    mu, lam = 0.01, 0.5
    x, tail, prev, thr = _fused_batch_inputs(rng, b, m, t, hop, ib)
    ah = _constraints(rng, u, s, m, nib, cuda)
    ah = ah / ah.abs().clamp_min(1e-30) * (ah != 0)
    w0 = _cplx(rng, (b, nib, s, m), cuda) * 0.1
    idx = torch.as_tensor(rng.integers(0, u, (b, 1)).repeat(t, 1),
                          device=cuda)
    idx[:, 100:] = 1 - idx[:, 100:]
    reset = torch.zeros((b, t), dtype=torch.bool, device=cuda)
    reset[:, 0] = reset[:, 100] = True
    before = kgss.gss_mega.launches
    got = kgss.gss_mega(x, tail, prev, w0, ah, idx, reset, ib, 2 * hop, thr,
                        mu, lam)
    torch.cuda.synchronize()
    assert kgss.gss_mega.launches == before + 1
    assert got[0].shape == (b, t * hop) and torch.isfinite(got[0]).all()
    ones = [kgss.gss_mega(x[i], tail[i], prev[i], w0[i], ah, idx[i],
                          reset[i], ib, 2 * hop, thr, mu, lam)
            for i in range(b)]
    assert _peak_rel(got[0], [o[0] for o in ones]) <= 1e-6
    for i, o in enumerate(ones):
        assert torch.equal(got[1][i], o[1]) and torch.equal(got[2][i], o[2])
    if b == NB16:
        cpu = [a.cpu() for a in (x, tail, prev, w0, ah, idx, reset, ib)]
        ref = kgss.gss_mega(*cpu, 2 * hop, thr, mu, lam)
        assert _rel(got[0].cpu(), ref[0]) < MVDR_REL
        assert _rel(got[1].cpu(), ref[1]) < MVDR_REL


@pytest.mark.parametrize("node,solver,exact", [
    ("das", None, True), ("mvdr", "auto", True), ("mvdr", "mega", False),
    ("lcmv", "auto", True), ("lcmv", "mega", False), ("gss", None, False),
    ("gsc", "sample", True), ("gsc", "blocklms", True),
    ("phase", None, True), ("phasempf", None, True), ("mcra", None, True),
    ("ref", None, True), ("read", None, True), ("mvdr", "dense", False),
    ("lcmv", "dense", False)])
def test_batch_runner_on_cuda_matches_single_streams(cuda, node, solver,
                                                     exact):
    """BatchRunner at three streams of 16 mics, two chunks: each stream
    equals the same model's single-stream streaming run on the card (bit
    for bit, or within 1e-6 of its peak where the fused kernels add with
    atomics or ``dense``'s batched einsums sum in another order), with each
    kernel of the path launched as often per chunk as one stream's call
    launches it (once; ``dense``'s Gauss-Jordan inverse once a block, twice
    for LCMV; ``ref`` and ``read`` launch none)."""
    from beamform_tpu_torch.kernels import gsc as kg
    from beamform_tpu_torch.kernels import gsc_blocklms as kb
    from beamform_tpu_torch.kernels import phase_mask as kpm
    from beamform_tpu_torch.runtime.batch import BatchRunner
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    if node in ("lcmv", "gss"):
        cfg = dataclasses.replace(cfg, interference_angles=(-60.0,))
    params = dict(load_launch_params(node))
    if node == "gsc":
        params["write_mu"] = False
    if solver:
        params["solver"] = solver
    rng = np.random.default_rng(7)
    hop, t = 1024, 24
    x = (0.1 * rng.standard_normal((NB16, 16, 2 * t * hop))).astype(
        np.float32)
    x[:, :, :12 * hop] *= 1e-4
    thetas = np.array([-40.0, 5.0, 50.0])
    runner = BatchRunner(node, EngineConfig(), cfg, params, batch=NB16,
                         device=cuda)
    fns = [kw.wola_analysis, kw.wola_synthesis, km.mvdr_stream,
           klc.lcmv_stream, kmega.mega_stream, kgss.gss_mega, kg.gsc_sample,
           kb.gsc_blocklms, kpm.phase_mask, kpm.mpf_march, kpm.mcra_march,
           kl.gj_inverse]
    sessions = [StreamingSession(get_model(node, EngineConfig(), cfg, params,
                                           device=cuda))
                for _ in range(NB16)]
    outs, ones = [], [[] for _ in range(NB16)]
    for c in range(2):
        xc = x[:, :, c * t * hop:(c + 1) * t * hop]
        before = [f.launches for f in fns]
        outs.append(runner.process(xc, thetas))
        ran = [f.launches - b for f, b in zip(fns, before)]
        before = [f.launches for f in fns]
        ones[0].append(sessions[0].process(xc[0], float(thetas[0])))
        single = [f.launches - b for f, b in zip(fns, before)]
        assert ran == single, (ran, single)
        assert sum(ran) >= (0 if node in ("ref", "read") else 1), ran
        for i in range(1, NB16):
            ones[i].append(sessions[i].process(xc[i], float(thetas[i])))
    got = torch.cat(outs, dim=1)
    assert torch.isfinite(got).all()
    for i in range(NB16):
        one = torch.cat(ones[i])
        if exact:
            assert torch.equal(got[i], one)
        else:
            assert float((got[i] - one).abs().max()
                         / one.abs().max()) <= 1e-6


@pytest.mark.parametrize("fs_in,fs_out", [(48000, 16000), (48000, 44100)])
def test_resample_on_the_card_matches_the_cpu(cuda, fs_in, fs_out):
    """The output resampler's convolution keeps float32 on the card (no
    TF32): within 1e-6 of peak of the same function on the CPU."""
    from beamform_tpu_torch.runtime.resample import resample
    x = (0.3 * np.random.default_rng(0).standard_normal((2, 48000))
         ).astype(np.float32)
    got = resample(x, fs_in, fs_out)
    ref = resample(x, fs_in, fs_out, device="cpu")
    assert got.device.type == "cuda" and got.shape == ref.shape
    assert _rel(got.cpu(), ref) <= 1e-6


def test_session_monitor_waits_for_the_card(cuda):
    """StreamingSession(monitor=True) stops a chunk's clock only once the
    card is done with the chunk: with ~50 ms of device work queued after
    the model's own, the chunk's wall takes that long, where its launches
    alone return in about a millisecond."""
    cfg = load_array_config(os.path.join(
        ROOT, "beamform_tpu_torch", "configs", "aira16.yaml"))
    model = get_model("das", EngineConfig(), cfg, device=cuda)
    x = (0.1 * np.random.default_rng(1).standard_normal((16, 4 * 1024))
         ).astype(np.float32)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    real = model.process_chunk

    def slow(*args, **kw):
        out = real(*args, **kw)
        a.record()
        torch.cuda._sleep(10 ** 8)       # ~50 ms at the H100's SM clock
        b.record()
        return out

    sess = StreamingSession(model, monitor=True)
    sess.process(x, 20.0)
    model.process_chunk = slow
    sess.process(x, 20.0)
    queued = a.elapsed_time(b)
    assert sess.monitor.chunks == 2 and queued > 20.0
    assert sess.monitor.chunk_walls[-1] * 1e3 >= queued
