"""Plain GSS: gss.cpp:51-156 (the float64 transliteration of the reference
project's node) vectorised over streams and bins, marching the frames.

A(f) holds the look direction and the interferers as columns (row 0 = 1,
lcmv.cpp:44-86), W(f) starts as A^H (gss.cpp:92-93). Per in-band bin and
frame where the mic-mean |X| / nfft passes ``freq_mag_threshold``: y = W x,
source 0 out, and the natural-gradient step (gss.cpp:124-136)

    E = y y^H with a zero diagonal, a = ||x||^4,
    W <- (1 - lambda mu) W - mu (4 S / a (E y) x^H + 2 / S (W A - I) A^H);

elsewhere in band 0.01 X_0 and no step; out of band (bin 0 too) 0;
``out_amp`` on the window.

W carries the whole history of the stream, which the reference cannot
march again within a run: a sampled chunk starts from the program's W and
overlap-add carry at the chunk's start (the port's state layout, ``(carry
(tail, out_prev), W (B, NIB, S, M), prev_theta)``), marches on with its
own state into the next chunk, and the stream's first chunks start from
the reference's own A^H and zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import common, lanes as lanes_mod


class Reference:
    def __init__(self, cfg: dict, thetas, hop: int, fs: float, device,
                 prec: common.Precision):
        p = cfg["params"]
        self.hop, self.nfft, self.prec, self.device = hop, 2 * hop, prec, \
            torch.device(device)
        self.thr = float(p["freq_mag_threshold"])
        self.amp = float(p["out_amp"])
        self.mu, self.lam = float(p["mu"]), float(p["lambda"])
        self.pre_hops = 1
        freqs = common.half_freqs(self.nfft, fs)
        self.ib_host = common.band_bins(freqs, p["freq_min"], p["freq_max"])
        self.ib = torch.as_tensor(self.ib_host, device=self.device)
        dist, ang = common.mic_polar(common.array_mics(cfg["array"]))
        f_ib = freqs[self.ib_host]
        look = common.steering(f_ib, common.delays(dist, ang, thetas))
        interf = common.steering(
            f_ib, common.delays(dist, ang, cfg["interference_angles"]))
        a = np.concatenate([look[:, None], np.broadcast_to(
            interf[None], (len(thetas),) + interf.shape)], axis=1)
        # (B, S, M, NIB) -> A (B, NIB, M, S)
        self.a = torch.as_tensor(a.transpose(0, 3, 2, 1),
                                 device=self.device).to(prec.cplx)
        self.win = common.sqrt_hann(self.nfft, self.device)

    def start(self, k: int, program_state):
        """The state chunk ``k`` starts from: A^H and a zero carry at the
        stream's start, else the program's (W, out_prev)."""
        if k == 0:
            b = self.a.shape[0]
            return (self.a.conj().transpose(-1, -2).contiguous(),
                    torch.zeros((b, self.hop), dtype=self.prec.real,
                                device=self.device))
        carry, w, _ = program_state
        return (w.to(self.device, self.prec.cplx),
                carry[1].to(self.device, self.prec.real))

    def march(self, x, gate, w, a):
        """x (T, L, M), gate (T, L), W (L, S, M), A (L, M, S) -> (y (T, L)
        the output bin, final W)."""
        op, s = self.prec.op, w.shape[-2]
        eye = torch.eye(s, dtype=w.dtype, device=w.device)
        a_h = op(a.conj().transpose(-1, -2))
        a = op(a)
        ys = []
        for t in range(x.shape[0]):
            xt = x[t]
            y = (op(w) @ op(xt)[..., None])[..., 0]              # (L, S)
            e = y[:, :, None] * y.conj()[:, None, :] * (1 - eye)
            alpha = (xt.abs() ** 2).sum(-1) ** 2
            ey = (op(e) @ op(y)[..., None])[..., 0]
            dj1 = (4.0 * s) * op(ey)[:, :, None] * op(xt.conj())[:, None, :]
            dj1 = dj1 / alpha[:, None, None]
            dj2 = (2.0 / s) * (op(op(w) @ a - eye) @ a_h)
            w_new = (1.0 - self.lam * self.mu) * w - self.mu * (dj1 + dj2)
            w = torch.where(gate[t][:, None, None], w_new, w)
            ys.append(torch.where(gate[t], y[:, 0], 0.01 * xt[:, 0]))
        return torch.stack(ys), w

    @torch.no_grad()
    def chunk(self, x_before: torch.Tensor, x: torch.Tensor, state):
        """x_before (B, M, hop), x (B, M, T*hop), state (W, out_prev) ->
        ((B, T*hop) float64 output, the ambiguous gate pairs' lanes,
        finish), ``finish(chosen)`` the state the next chunk starts
        from."""
        w0, out_prev = state
        b, m, s_len = x.shape
        h, prec = self.hop, self.prec
        t = s_len // h
        xx = torch.cat([x_before, x], -1).to(self.device)
        x_ib = common.analysis(xx, h, self.win, prec).index_select(
            -1, self.ib)                                     # (B, M, T, NIB)
        nib = x_ib.shape[-1]
        stat = common.gate_statistic(x_ib, self.nfft)       # (B, T, NIB)
        gate = stat > self.thr
        xs = x_ib.permute(2, 0, 3, 1).reshape(t, b * nib, m)
        a = self.a.reshape(b * nib, m, -1)
        y, w_end = self.march(xs, gate.permute(1, 0, 2).reshape(t, -1),
                              w0.reshape(b * nib, -1, m), a)
        y = y.reshape(t, b, nib).transpose(0, 1)             # (B, T, NIB)
        y_half = torch.zeros((b, t, h + 1), dtype=prec.cplx,
                             device=self.device)
        y_half[..., self.ib] = y
        audio, carry = common.synthesis(y_half, self.win, h, out_prev,
                                        self.amp)
        w_end = w_end.reshape(b, nib, -1, m)

        lanes = self._lanes(xs, gate, stat, w0, a, y, nib)

        def finish(chosen):
            w_next, c_next = w_end.clone(), carry.clone()
            extra = lanes_mod.carry_deltas(lanes, chosen, b, s_len, h)
            for lane, v in zip(lanes, chosen):
                jj = lane.payload[0]
                w_next[lane.stream, jj] = lane.payload[1][v]
            c_next += torch.as_tensor(extra / self.amp, device=self.device,
                                      dtype=c_next.dtype)
            return w_next, c_next

        return audio.double().cpu().numpy(), lanes, finish

    def _lanes(self, xs, gate, stat, w0, a, y, nib):
        """One lane per (stream, bin) with ambiguous frames: every
        combination of their branches (up to ``MAX_FLIPS`` of them),
        marched from the chunk's start state."""
        amb = common.ambiguous(stat, self.thr, lanes_mod.MARGIN)
        pairs = amb.any(1).nonzero().tolist()                # (b, jj)
        if not pairs:
            return []
        h, t = self.hop, xs.shape[0]
        specs, gates = [], []
        for bb, jj in pairs:
            frames = amb[bb, :, jj].nonzero()[:, 0][:lanes_mod.MAX_FLIPS]
            k = len(frames)
            bits = ((torch.arange(2 ** k, device=self.device)[:, None]
                     >> torch.arange(k, device=self.device)) & 1).bool()
            g = gate[bb, :, jj].expand(2 ** k, t).clone()
            g[:, frames] ^= bits
            specs.append((bb, jj, int(frames[0]), 2 ** k))
            gates.append(g)
        g_all = torch.cat(gates).T                           # (T, V_all)
        lane_idx = torch.as_tensor(
            [bb * nib + jj for bb, jj, _, v in specs for _ in range(v)],
            device=self.device)
        m = xs.shape[-1]
        ys, ws = self.march(xs[:, lane_idx], g_all,
                            w0.reshape(-1, w0.shape[-2], m)[lane_idx],
                            a[lane_idx])
        lanes, i = [], 0
        for bb, jj, f1, v in specs:
            dy = (ys[:, i:i + v] - y[bb, :, jj][:, None]).T  # (V, T)
            aud = lanes_mod.bin_audio(dy, int(self.ib_host[jj]), h,
                                      self.amp)
            lanes.append(lanes_mod.Lane(bb, f1 * h, aud[:, f1 * h:],
                                        [jj, ws[i:i + v]]))
            i += v
        return lanes


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
        w, prev = finish([])
        self.state = ((None, prev), w, None)
        self._tail = x[..., -self.ref.hop:]
        self.k += 1
        return torch.as_tensor(out, dtype=torch.float32)
