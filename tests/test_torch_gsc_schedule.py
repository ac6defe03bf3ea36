"""The schedule of the CUDA per-sample GSC kernel (``csrc/gsc_sample.cu``),
modelled in plain torch and held to the per-sample recurrence
(``kernels/gsc.py gsc_sample_plain``) in float64, on the CPU.

The kernel runs the recurrence in groups of L = 8 samples inside each
128-sample tile by the exact lookahead factorisation: a group's outputs are
the fixed beam less the base dots against the taps at an earlier group's
start, less the step products of the samples since then times the
window-pair Grams summed over the channels. The model below does the same
algebra in the same order of terms: base dots of group n + 1 against the
taps at group n's start plus the cross-group Gram terms (lags up to
2L - 1), the Gram tables as fresh window sums (the history's products
after the sample, those reaching before the register masked out, plus the
tile's up to it), a restart at every tile, and the replay of a group
sample by sample where a step's output or step product is not finite or a
channel is on the q branch with a non-zero update. In float64 its
rounding is far below the bar, so any slip in the algebra (a lag, a sign,
a window's edge, a restart) shows at once.

Serial, ~1 ms a sample here: each case keeps to at most 1,024 samples.
"""

import numpy as np
import pytest
import torch

from beamform_tpu_torch.config import GscParams
from beamform_tpu_torch.kernels import gsc as tk

K = 128
TILE = 128
L = 8


def _operands(m, s, seed, dtype=torch.float64):
    """Aligned audio (1, M, S) and a carried state of the audio's scale."""
    rng = np.random.default_rng(seed)

    def t(shape, scale):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=dtype)

    return (t((1, m, s), 0.2), t((1, m - 1, K), 0.2),
            t((1, m - 1, K), 0.01), t((1, K), 0.1))


def _params(**kw):
    return GscParams(**dict(dict(mu0=0.0005, mu_max=0.05, filter_size=K,
                                 vad_threshold=0.05), **kw))


def _tile_tables(ue, t0, c_b, mu0):
    """One tile's input-only tables from ue (C, K + S), the [register |
    chunk] rows, as the kernel forms them: bsq_c(i), SG(i, l) for lags
    1 .. 2L - 1 (fresh window sums: the last tile's products after i, the
    products reaching before the register masked out, plus this tile's up
    to i), c_b bsq_c, the q steps and max_c c_b bsq_c."""
    hist = ue[:, t0:t0 + TILE]                 # the last tile (or register)
    tile = ue[:, K + t0:K + t0 + TILE]
    before = ue[:, K + t0 - 2 * L:K + t0]       # the history's last samples

    def sums(y, x):
        # sum_{h > i} y(h) + sum_{j <= i} x(j)
        suffix = torch.flip(torch.cumsum(torch.flip(y, [-1]), -1), [-1])
        suffix = torch.cat([suffix[..., 1:], suffix.new_zeros(
            suffix.shape[:-1] + (1,))], -1)
        return suffix + torch.cumsum(x, -1)

    bsq = sums(hist * hist, tile * tile)                       # (C, T)
    idx = torch.arange(TILE)
    sg = []
    for lag in range(1, 2 * L):
        hl = torch.cat([hist.new_zeros(hist.shape[0], lag),
                        hist[:, :TILE - lag]], -1)
        y = torch.where(idx >= lag, hist * hl, hist.new_zeros(()))
        tl = torch.cat([before[:, 2 * L - lag:], tile[:, :TILE - lag]], -1)
        sg.append(sums(y, tile * tl).sum(0))
    sg = torch.stack(sg)                                       # (2L-1, T)
    q = mu0 * torch.rsqrt(torch.clamp_min(bsq / K, 0.0))
    q = torch.where(q < torch.inf, q, 0.0)
    cb = c_b * bsq
    mx = torch.where(torch.isnan(cb).any(0), torch.nan, cb.max(0).values)
    return sg, cb, q, mx


def schedule_model(aligned, block, filt, last_out, p):
    """gsc_sample_kernel's schedule for one stream: (out (S,), block',
    filt', last_out', mu trace (S,), update flags (S,), groups factorised,
    groups replayed)."""
    a, blk, flt, lo = aligned[0], block[0], filt[0], last_out[0]
    m, s = a.shape
    dt = a.dtype
    u = a[1:] - a[:-1]
    d = a.mean(0)
    ue = torch.cat([blk, u], -1)                               # (C, K + S)
    c_b, c_o = p.mu0 * p.mu0 / K, p.mu_max * p.mu_max / K
    out = torch.zeros(s, dtype=dt)
    mu_tr = torch.zeros(s, dtype=dt)
    upd_tr = torch.zeros(s, dtype=torch.bool)
    ob = lo.clone()                        # the last K outputs
    g = flt.clone()
    n_fact = n_rep = 0

    def win(t):                            # b_c(t), (C, K)
        return ue[:, t + 1:t + 1 + K]

    def step(osq):
        # the osq-branch step (0 where not finite) and the VAD gate
        with np.errstate(divide="ignore", invalid="ignore"):
            pv = np.float64(p.mu0) / np.sqrt(np.float64(osq) / K)
            upd = (not p.use_vad) or bool(np.sqrt(osq / K) < p.vad_threshold)
        return (float(pv) if pv < np.inf else 0.0), upd

    for t0 in range(0, s, TILE):
        sg, cb, q, mx = _tile_tables(ue, t0, c_b, p.mu0)
        sq = ob * ob
        hs = torch.flip(torch.cumsum(torch.flip(sq, [0]), 0), [0])
        hs = torch.cat([hs[1:], hs.new_zeros(1)])             # after i
        tp = 0.0
        base_taps, cross = g.clone(), torch.zeros(L, dtype=dt)
        tile_out = torch.zeros(TILE, dtype=dt)
        for n in range(TILE // L):
            t0g = n * L
            ts = [t0 + t0g + r for r in range(L)]
            e = torch.stack([d[t] - (base_taps * win(t)).sum()
                             for t in ts])
            cr = cross.clone()
            nxt = torch.zeros(L, dtype=dt)
            ws, os_, tp0, bad = [], [], tp, False
            for si in range(L):
                i = t0g + si
                o = float(e[si] - cr[si])
                tp = tp + o * o
                osq = float(hs[i]) + tp
                pv, upd = step(osq)
                co = c_o * osq
                ou = o if upd else 0.0
                on = bool(mx[i] < co)
                w = pv * ou if on else 0.0
                bad |= not (np.isfinite(o) and np.isfinite(w)) or \
                    (not on and ou != 0.0)
                for r in range(si + 1, L):
                    cr[r] = cr[r] + w * sg[r - si - 1, t0g + r]
                if n + 1 < TILE // L:
                    for r in range(L):
                        nxt[r] = nxt[r] + w * sg[L + r - si - 1,
                                                 t0g + L + r]
                ws.append(w)
                os_.append(o)
                mu_tr[t0 + i] = pv if cb[0, i] < co else q[0, i]
                upd_tr[t0 + i] = upd
            if not bad:
                n_fact += 1
                tile_out[t0g:t0g + L] = torch.tensor(os_, dtype=dt)
                start = g.clone()
                delta = sum(w * win(t) for w, t in zip(ws, ts))
                g = g + delta
                g = torch.where(torch.isnan(g), 0.0, g)
                base_taps, cross = start, nxt
            else:
                # replay: the per-sample recurrence from the group's taps
                n_rep += 1
                tp = tp0
                for si, t in enumerate(ts):
                    i = t0g + si
                    bw = win(t)
                    o = float(d[t] - (g * bw).sum())
                    tp = tp + o * o
                    osq = float(hs[i]) + tp
                    pv, upd = step(osq)
                    co = c_o * osq
                    mu = torch.where(cb[:, i] < co, pv, q[:, i])
                    if upd:
                        g = g + (mu * o)[:, None] * bw
                        g = torch.where(torch.isnan(g), 0.0, g)
                    tile_out[i] = o
                    mu_tr[t0 + i] = mu[0]
                    upd_tr[t0 + i] = upd
                # the next group restarts: fresh base dots, no cross terms
                base_taps, cross = g.clone(), torch.zeros(L, dtype=dt)
        out[t0:t0 + TILE] = tile_out
        ob = tile_out.clone()
    return (out, ue[:, -K:].clone(), torch.where(torch.isnan(g), 0.0, g),
            ob, mu_tr, upd_tr, n_fact, n_rep)


def _peak_rel(got, ref):
    fin = torch.isfinite(ref)
    return float((got[fin] - ref[fin]).abs().max() / ref[fin].abs().max())


@pytest.mark.parametrize("m", [4, 16])
@pytest.mark.parametrize("use_vad", [False, True])
def test_schedule_matches_the_recurrence(m, use_vad):
    """Finite input from a carried state, two tiles: every group runs
    factorised (no replay), and the outputs, taps, registers, last outputs
    and the mu trace equal the per-sample recurrence's to 1e-12."""
    ops = _operands(m, 2 * TILE, 11 + m + use_vad)
    # the threshold at the median power of the ungated run's outputs
    free = tk.gsc_sample_plain(*ops, _params())[0]
    level = float(torch.sqrt(tk.window_sums(free * free, K) / K).median())
    p = _params(use_vad=use_vad, vad_threshold=level)
    got = schedule_model(*ops, p)
    ref = tk.gsc_sample_plain(*ops, p, with_mu=True)
    assert got[7] == 0 and got[6] == 2 * TILE // L
    assert _peak_rel(got[0], ref[0][0]) <= 1e-12
    assert _peak_rel(got[2], ref[2][0]) <= 1e-12
    assert torch.equal(got[1], ref[1][0])
    assert _peak_rel(got[3], ref[3][0]) <= 1e-12
    assert _peak_rel(got[4], ref[4][0][0]) <= 1e-12
    assert torch.equal(got[5], ref[4][1][0])
    if use_vad:
        assert 0 < int(got[5].sum()) < got[5].numel()


@pytest.mark.parametrize("m", [4, 16])
@pytest.mark.parametrize("where", [TILE + L - 1, 2 * TILE, 300])
def test_schedule_replays_around_a_nan_sample(m, where):
    """A NaN input sample (at a group's last sample, a tile's first, and
    mid-group): the groups whose windows hold it are replayed sample by
    sample; NaN outputs exactly where the recurrence has them, the taps
    scrubbed, the rest within 1e-12; the factorised path resumes after."""
    ops = _operands(m, 4 * TILE, 5 + m)
    ops[0][0, 1, where] = float("nan")
    p = _params()
    got = schedule_model(*ops, p)
    ref = tk.gsc_sample_plain(*ops, p)
    assert torch.equal(torch.isnan(got[0]), torch.isnan(ref[0][0]))
    assert bool(torch.isnan(got[0][where]))
    assert _peak_rel(got[0], ref[0][0]) <= 1e-12
    assert not torch.isnan(got[2]).any()
    assert _peak_rel(got[2], ref[2][0]) <= 1e-12
    assert got[7] > 0 and got[6] > 0
    # after the NaN has left every window the groups run factorised again
    assert got[6] + got[7] == 4 * TILE // L


def test_schedule_silent_lead_in_needs_no_replay():
    """A silent lead-in from a zero state: every output is exactly 0 (osq
    0, every channel on the q branch, but no update), then the audio's
    first group is on the osq branch: no group is replayed."""
    a, blk, flt, lo = _operands(4, 2 * TILE, 9)
    a[..., :TILE + 3 * L] = 0.0
    zero = [torch.zeros_like(x) for x in (blk, flt, lo)]
    p = _params()
    got = schedule_model(a, *zero, p)
    ref = tk.gsc_sample_plain(a, *zero, p, with_mu=True)
    assert torch.equal(got[0][:TILE + 3 * L],
                       torch.zeros(TILE + 3 * L, dtype=torch.float64))
    assert got[7] == 0
    assert _peak_rel(got[0], ref[0][0]) <= 1e-12
    assert _peak_rel(got[4], ref[4][0][0]) <= 1e-12
