"""Plain GSC: gsc.cpp:54-197 (the float64 transliteration of the reference
project's node) vectorised over streams and channels, marching the
samples one at a time.

Stage 1 (gsc.cpp:54-75, the by-mic WOLA of util.h:318-379): each mic's
window of 2*hop samples, sqrt-Hann windowed, through the full complex FFT,
times the conjugate steering over the node's whole frequency vector (its
quirks kept: f[N/2-1] = fs/2, f[N/2] = 0, and the negative half holds the
values the overwrite missed, so bin N/2+1 is not bin N/2-1's mirror), the
real part of the inverse FFT windowed again and overlap-added per mic.

Stage 2 (gsc.cpp:120-179), per sample of each stream, from the M aligned
samples a:

    das = mean of a over mics; u_c = a_{c+1} - a_c shifts into channel c's
    K-tap blocking register b_c (C = M - 1 channels);
    out = das - sum_c <g_c, b_c>; out shifts into the K last outputs;
    last_pow = sqrt(mean(last_out^2)), bp_c = sqrt(mean(b_c^2)), both
    fresh from the windows as they now stand;
    if last_pow < vad_threshold or not use_vad, per channel:
        mu_c = mu0 / last_pow if mu0 bp_c / last_pow < mu_max
               else mu0 / bp_c, and 0 where that is NaN or infinite;
        g_c += mu_c out b_c, then NaN taps of g_c are 0.

The samples are never vectorised: only the streams and the channels are.
What depends on the input alone (das, u, the windows' bp_c and the
second branch's mu_c) is formed for the whole chunk first; each step then
holds the dot product, the output's window norm, the branch and the
update. With n = ||last_out|| = sqrt(K) last_pow the branch reads
``mu0 sqrt(K) / mu_max * bp_c < n``, the same test for every n >= 0, 0
and NaN included (both sides are then false), and the first branch's
step is mu0 sqrt(K) / n. On the card each hop's steps are captured once as
a CUDA graph and replayed (plain torch operations, without a launch from
the host per operation); on the CPU they run as they are.

The registers and the overlap-add carry run through the stream's whole
history, which the reference cannot march again within a run: a sampled
chunk starts from the program's state at the chunk's start (the port's
layout, ``(WolaCarry(tail, out_prev (B, M, hop)), GscState(block (B, C,
K), filt (B, C, K), last_out (B, K), ...))``; the tail is the input's own
hop before the chunk, which the check hands over), marches on with its own
state into the next chunk, and the stream's first chunks start from zeros.
GSC has no energy gate, so no pair is ambiguous and there are no lanes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import common


def full_freqs(nfft: int, fs: float) -> np.ndarray:
    """calculate_frequency_vector (util.h:190-199) over all N bins: bins
    0..N/2 as ``common.half_freqs`` (f[N/2-1] = fs/2, f[N/2] = 0), bins
    N/2+1..N-1 the negatives of bins N/2-1..1 before the overwrite."""
    f = np.zeros(nfft)
    f[:nfft // 2 + 1] = common.half_freqs(nfft, fs)
    j = np.arange(1, nfft // 2)
    f[nfft - j] = -j * fs / nfft
    return f


class Reference:
    def __init__(self, cfg: dict, thetas, hop: int, fs: float, device,
                 prec: common.Precision):
        p = cfg["params"]
        self.hop, self.nfft, self.prec, self.device = hop, 2 * hop, prec, \
            torch.device(device)
        self.use_vad = bool(p["use_vad"])
        self.vad = float(p["vad_threshold"])
        self.mu0, self.mu_max = float(p["mu0"]), float(p["mu_max"])
        self.k = int(p["filter_size"])
        self.pre_hops = 1
        # no energy gate: every bin 1..hop is in band and passes a zero
        # threshold, so ``gate_counts`` (and the run's log) read ~1.0
        self.ib_host = np.arange(1, hop + 1)
        self.ib = torch.as_tensor(self.ib_host, device=self.device)
        self.thr = 0.0
        dist, ang = common.mic_polar(common.array_mics(cfg["array"]))
        tau = common.delays(dist, ang, thetas)               # (B, M)
        w = np.exp(-2j * np.pi * tau[:, :, None]
                   * full_freqs(self.nfft, fs)[None, None, :])
        self.w_conj = torch.as_tensor(w.conj(), device=self.device) \
            .to(prec.cplx)                                   # (B, M, N)
        self.win = common.sqrt_hann(self.nfft, self.device)
        self.block = 8                      # streams a stage-1 pass
        self._hop = None                    # (buffers, run), at first use

    def start(self, k: int, program_state):
        """The state chunk ``k`` starts from: (out_prev, block, filt,
        last_out), zeros at the stream's start, else the program's."""
        real, dev = self.prec.real, self.device
        if k == 0:
            b, m = self.w_conj.shape[:2]
            return (torch.zeros((b, m, self.hop), dtype=real, device=dev),
                    torch.zeros((b, m - 1, self.k), dtype=real, device=dev),
                    torch.zeros((b, m - 1, self.k), dtype=real, device=dev),
                    torch.zeros((b, self.k), dtype=real, device=dev))
        carry, gs = program_state[0], program_state[1]
        return tuple(t.to(dev, real) for t in (carry[1], gs[0], gs[1],
                                                 gs[2]))

    def align(self, xx: torch.Tensor, out_prev: torch.Tensor):
        """Stage 1: xx (B, M, (T+1)*hop), out_prev (B, M, hop) -> ((B, M,
        T*hop) aligned samples, the new out_prev)."""
        h, prec = self.hop, self.prec
        win = self.win.to(prec.real)
        outs, prevs = [], []
        for b0 in range(0, xx.shape[0], self.block):
            b1 = min(b0 + self.block, xx.shape[0])
            frames = xx[b0:b1].to(prec.real).unfold(-1, 2 * h, h) * win
            spec = torch.fft.fft(frames.to(prec.cplx), dim=-1)
            p = torch.fft.ifft(spec * self.w_conj[b0:b1, :, None, :],
                               dim=-1).real * win            # (b, M, T, 2h)
            first = p[..., :h].clone()
            first[:, :, 0] += out_prev[b0:b1]
            first[:, :, 1:] += p[:, :, :-1, h:]
            outs.append(first.reshape(first.shape[0], first.shape[1], -1))
            prevs.append(p[:, :, -1, h:])
        return torch.cat(outs), torch.cat(prevs)

    def _hop_steps(self):
        """The static buffers of one hop's steps for the B streams and C
        channels and the function that runs the steps on them (on the
        card a CUDA graph's replay), built at the first call."""
        if self._hop is not None:
            return self._hop
        b, m = self.w_conj.shape[:2]
        k, h, c = self.k, self.hop, m - 1
        dt, dev = self.prec.real, self.device
        bufs = dict(
            u=torch.zeros((b, k + h, c), dtype=dt, device=dev),
            das=torch.zeros((h, b), dtype=dt, device=dev),
            q=torch.zeros((h, b, c), dtype=dt, device=dev),
            mu_b=torch.zeros((h, b, c), dtype=dt, device=dev),
            out=torch.zeros((k + h, b), dtype=dt, device=dev),
            filt=torch.zeros((b, k, c), dtype=dt, device=dev),
            c_o=torch.tensor(self.mu0 * math.sqrt(k), dtype=dt, device=dev))
        run = lambda: self._steps(**bufs)                    # noqa: E731
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                run()                       # cuBLAS and allocator warm-up
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                run()
            run = graph.replay
        self._hop = bufs, run
        return self._hop

    def _steps(self, u, das, q, mu_b, out, filt, c_o):
        """One hop of samples on the static buffers: ``u`` (B, K+hop, C)
        the blocking samples (the K before the hop first; as the products
        take them), ``das`` (hop, B), ``q`` and ``mu_b`` (hop, B, C) the
        branch's threshold mu0 sqrt(K) / mu_max bp_c and the second
        branch's step, ``out`` (K+hop, B) the K last outputs then the
        hop's, ``filt`` (B, K, C) the filters, updated in place."""
        b, kc = filt.shape[0], filt.shape[1] * filt.shape[2]
        k, op = self.k, self.prec.op
        lim = self.vad * math.sqrt(k)
        for j in range(das.shape[0]):
            reg = u[:, j + 1:j + 1 + k]                      # (B, K, C)
            dot = torch.bmm(op(filt).view(b, 1, kc), reg.reshape(b, kc, 1))
            torch.sub(das[j], dot.view(b), out=out[k + j])
            n = torch.linalg.vector_norm(out[j + 1:j + 1 + k], dim=0)
            mu = torch.where(q[j] < n[:, None], torch.div(c_o, n)[:, None],
                             mu_b[j])
            step = op(mu * out[k + j][:, None])[:, None, :]  # (B, 1, C)
            if not self.use_vad:
                filt.addcmul_(step, reg)
                filt.nan_to_num_(nan=0.0, posinf=math.inf,
                                 neginf=-math.inf)
                continue
            new = torch.addcmul(filt, step, reg).nan_to_num_(
                nan=0.0, posinf=math.inf, neginf=-math.inf)
            filt.copy_(torch.where((n < lim)[:, None, None], new, filt))

    def adapt(self, a: torch.Tensor, block, filt, last_out):
        """Stage 2: a (B, M, S) aligned samples, the registers block and
        filt (B, C, K) and last_out (B, K) -> ((B, S) output, block',
        filt', last_out')."""
        k, h, s = self.k, self.hop, a.shape[-1]
        das = a.mean(1)                                      # (B, S)
        ue = torch.cat([block, a[:, 1:] - a[:, :-1]], -1)    # (B, C, K+S)
        # each sample's register is ue[..., t+1:t+1+K]; its power fresh
        bp = torch.sqrt((ue * ue).unfold(-1, k, 1)[..., 1:, :].sum(-1) / k)
        mu_b = self.mu0 / bp
        mu_b = torch.where(mu_b < math.inf, mu_b, 0.0)       # (B, C, S)
        q = bp * (self.mu0 * math.sqrt(k) / self.mu_max)
        u_all = self.prec.op(ue.transpose(1, 2).contiguous())  # (B, K+S, C)
        bufs, run = self._hop_steps()
        bufs["filt"].copy_(filt.transpose(1, 2))
        bufs["out"][:k] = last_out.T
        outs = []
        for t0 in range(0, s, h):
            bufs["u"].copy_(u_all[:, t0:t0 + k + h])
            bufs["das"].copy_(das[:, t0:t0 + h].T)
            bufs["q"].copy_(q[..., t0:t0 + h].permute(2, 0, 1))
            bufs["mu_b"].copy_(mu_b[..., t0:t0 + h].permute(2, 0, 1))
            run()
            outs.append(bufs["out"][k:].T.clone())
            bufs["out"][:k] = bufs["out"][h:].clone()
        return (torch.cat(outs, -1), ue[..., s:].contiguous(),
                bufs["filt"].transpose(1, 2).contiguous(),
                bufs["out"][:k].T.contiguous())

    @torch.no_grad()
    def chunk(self, x_before: torch.Tensor, x: torch.Tensor, state):
        """x_before (B, M, hop), x (B, M, T*hop), state (out_prev, block,
        filt, last_out) -> ((B, T*hop) float64 output, no lanes, finish),
        ``finish(chosen)`` the state the next chunk starts from."""
        out_prev, block, filt, last_out = state
        xx = torch.cat([x_before, x], -1).to(self.device)
        aligned, prev = self.align(xx, out_prev)
        y, block, filt, last_out = self.adapt(aligned, block, filt,
                                              last_out)
        return (y.double().cpu().numpy(), [],
                lambda chosen: (prev, block, filt, last_out))


class Serve:
    """The reference put in the program's place (the control), with its
    state in the port's layout, so the check reads it as the program's."""

    def __init__(self, ref: Reference):
        self.ref, self.k, self.state = ref, 0, None
        self._tail = None

    def process(self, x, theta=None) -> torch.Tensor:
        if self._tail is None:
            self._tail = torch.zeros(x.shape[:2] + (self.ref.hop,),
                                     dtype=x.dtype, device=x.device)
        st = self.ref.start(self.k, self.state)
        out, _, finish = self.ref.chunk(self._tail, x, st)
        prev, block, filt, last_out = finish([])
        self.state = ((None, prev), (block, filt, last_out))
        self._tail = x[..., -self.ref.hop:]
        self.k += 1
        return torch.as_tensor(out, dtype=torch.float32)
