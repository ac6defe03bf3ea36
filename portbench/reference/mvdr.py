"""Plain MVDR: mvdr.cpp:62-115 (the float64 transliteration of the
reference project's node) vectorised over streams, frames and bins.

Per in-band bin: R = (P P^H) .* (1 + 0.001 I) from the last
``past_windows`` spectra, w = R^-1 d / (d^H R^-1 d), y = w^H x where the
mic-mean |X| / nfft passes ``freq_mag_threshold``, else 0.01 X_0; bin 0
passes X_0; other bins 0; ``out_amp`` on the window. The history shifts
every in-band frame, gate or not, so a chunk's output is a function of
its input and the ``past_windows + 2`` hops before it alone: the
reference takes nothing of the program's state.
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
        self.w_hist = int(p["past_windows"])
        self.thr = float(p["freq_mag_threshold"])
        self.amp = float(p["out_amp"])
        self.pre_hops = self.w_hist + 2
        freqs = common.half_freqs(self.nfft, fs)
        self.ib_host = common.band_bins(freqs, p["freq_min"], p["freq_max"])
        self.ib = torch.as_tensor(self.ib_host, device=self.device)
        dist, ang = common.mic_polar(common.array_mics(cfg["array"]))
        d = common.steering(freqs[self.ib_host],
                            common.delays(dist, ang, thetas))
        self.d = torch.as_tensor(d, device=self.device).to(prec.cplx)
        self.win = common.sqrt_hann(self.nfft, self.device)
        self.block = 4                      # streams a pass, to bound memory

    def start(self, k: int, program_state):
        """The state chunk ``k`` starts from: none, the input holds it."""
        return None

    @torch.no_grad()
    def chunk(self, x_before: torch.Tensor, x: torch.Tensor, state=None):
        """x_before (B, M, pre_hops*hop) and x (B, M, T*hop) -> ((B, T*hop)
        float64 output, the ambiguous gate pairs' lanes, finish), where
        ``finish(chosen)`` gives the next chunk's state (none)."""
        b_all, m, s_len = x.shape
        h, w_hist, prec = self.hop, self.w_hist, self.prec
        t = s_len // h
        white = (torch.ones((m, m), dtype=prec.real, device=self.device)
                 + 0.001 * torch.eye(m, dtype=prec.real, device=self.device))
        out = np.empty((b_all, s_len))
        lanes = []
        for b0 in range(0, b_all, self.block):
            b1 = min(b0 + self.block, b_all)
            xx = torch.cat([x_before[b0:b1], x[b0:b1]], -1).to(self.device)
            spec = common.analysis(xx, h, self.win, prec)  # (b, M, F, h+1)
            x_ib = spec.index_select(-1, self.ib)            # (b, M, F, NIB)
            stat = common.gate_statistic(x_ib, self.nfft)[:, w_hist:]
            # frames w_hist..F-1 are processed (the first of them is the
            # pre-roll's last, whose window's second half starts the chunk);
            # each solves over the w_hist frames before it
            hist = x_ib.unfold(2, w_hist, 1)[:, :, :t + 1]   # (b,M,T+1,NIB,W)
            hist = prec.op(hist.permute(0, 2, 3, 1, 4))      # (b,T+1,NIB,M,W)
            r = (hist @ hist.conj().transpose(-1, -2)) * white
            d = self.d[b0:b1, None].transpose(-1, -2)        # (b,1,NIB,M)
            num = torch.linalg.solve_ex(prec.op(r), prec.op(d)[..., None]
                                        .expand(r.shape[:-1] + (1,)))[0]
            num = num[..., 0]
            den = (prec.op(d.conj()) * prec.op(num)).sum(-1, keepdim=True)
            wts = num / den
            xq = x_ib[:, :, w_hist:].permute(0, 2, 3, 1)     # (b,T+1,NIB,M)
            solved = (prec.op(wts.conj()) * prec.op(xq)).sum(-1)
            passed = 0.01 * xq[..., 0]
            gate = stat > self.thr
            y = torch.where(gate, solved, passed)
            y_half = torch.zeros(y.shape[:2] + (h + 1,), dtype=prec.cplx,
                                 device=self.device)
            y_half[..., self.ib] = y
            y_half[..., 0] = spec[:, 0, w_hist:, 0]
            p0 = torch.fft.irfft(y_half[:, 0], n=self.nfft, dim=-1) \
                * self.win.to(prec.real)
            audio, _ = common.synthesis(y_half[:, 1:], self.win, h,
                                        p0[:, h:], self.amp)
            out[b0:b1] = audio.double().cpu().numpy()
            for bb, q, jj in common.ambiguous(stat, self.thr,
                                              lanes_mod.MARGIN).nonzero() \
                    .tolist():
                alt = passed if gate[bb, q, jj] else solved
                dy = torch.stack([torch.zeros_like(y[bb, q, jj]),
                                  alt[bb, q, jj] - y[bb, q, jj]])[:, None]
                aud = lanes_mod.bin_audio(dy, int(self.ib_host[jj]), h,
                                          self.amp)
                # frame q's window covers chunk samples [(q-1)h, (q+1)h)
                lo = (q - 1) * h
                lanes.append(lanes_mod.Lane(b0 + bb, max(lo, 0),
                                            aud[:, max(-lo, 0):]))
        return out, lanes, lambda chosen: None


class Serve:
    """The reference put in the program's place (the control): the
    ``BatchRunner.process`` contract, at the reference's precision."""

    def __init__(self, ref: Reference):
        self.ref, self.state, self._before = ref, None, None

    def process(self, x, theta=None) -> torch.Tensor:
        if self._before is None:
            self._before = torch.zeros(x.shape[:2] + (self.ref.pre_hops
                                                      * self.ref.hop,),
                                       dtype=x.dtype, device=x.device)
        out = self.ref.chunk(self._before, x)[0]
        self._before = x[..., -self._before.shape[-1]:]
        return torch.as_tensor(out, dtype=torch.float32)
