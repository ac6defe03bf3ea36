"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and a configuration's scene (its array, its talkers' directions, its
interferers) -> each stream's audio, made on the device from the seed.

Every stream is its own scene on the configuration's array: a talker at
the stream's direction and one talker at each interference angle, each
a pink-ish source (bench.py's ``make_speech_input`` spectrum) under a
syllabic and a phrase envelope, delayed to every mic exactly (far field,
in the frequency domain over the whole ring, so the ring wraps without a
seam), and a noise floor of independent N(0, sigma) per mic. The ring's
first chunk opens with a quiet lead-in. The envelopes' phases follow the
stream index, not the seed, so every seed gives the same gate share and
the same work, in other samples.

The ring is (chunks, B, M, T*hop) float32: chunk ``k`` of the run reads
slot ``k % chunks``, a contiguous view, so handing it to the program
copies nothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.common import array_mics, delays, mic_polar

GOLDEN = 0.6180339887498949


def talker_thetas(cfg: dict, streams: int) -> np.ndarray:
    """Each stream's talker direction (degrees): evenly over the
    configuration's ``talker_theta_deg`` span."""
    lo, hi = cfg["talker_theta_deg"]
    return np.linspace(lo, hi, streams)


def envelope(n: int, fs: float, env: dict, phase: float, device):
    """bench.py's envelope: clip(sin(2 pi f_s t + phase) + offset, 0, 1)
    times the phrase gate sin(2 pi f_p t + 1 + phase) > cut."""
    t = torch.arange(n, dtype=torch.float64, device=device) / fs
    syl = torch.clamp(torch.sin(2 * math.pi * env["syllable_hz"] * t + phase)
                      + env["syllable_offset"], 0.0, 1.0)
    phr = torch.sin(2 * math.pi * env["phrase_hz"] * t + 1.0 + phase) \
        > env["phrase_cut"]
    return (syl * phr).to(torch.float32)


class Ring:
    """The cell's input ring and the view of it each chunk takes."""

    def __init__(self, data: torch.Tensor, hop: int):
        self.data, self.hop = data, hop
        self.slots = data.shape[0]

    def chunk(self, k: int) -> torch.Tensor:
        """(B, M, T*hop): the audio of the run's chunk ``k``."""
        return self.data[k % self.slots]

    def before(self, k: int, hops: int) -> torch.Tensor:
        """(B, M, hops*hop): the audio just before chunk ``k`` (zeros before
        the stream's start)."""
        if k == 0:
            b, m = self.data.shape[1:3]
            return torch.zeros((b, m, hops * self.hop), dtype=self.data.dtype,
                               device=self.data.device)
        return self.chunk(k - 1)[..., -hops * self.hop:]


@torch.no_grad()
def make_ring(cfg: dict, mix: dict, seed: int, hop: int, fs: float,
              device) -> Ring:
    b, t, slots = mix["streams"], mix["chunk_hops"], mix["ring_chunks"]
    mics = array_mics(cfg["array"])
    m, n = len(mics), slots * t * hop
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ring = torch.randn((slots, b, m, t * hop), generator=gen, device=device)
    ring *= mix["noise_sigma"]
    dist, ang = mic_polar(mics)
    thetas = talker_thetas(cfg, b)
    interf = list(cfg.get("interference_angles", []))
    srcs = [(mix["talker"], thetas)] + [
        (mix["interferer"], np.full(b, a)) for a in interf]
    f = torch.fft.rfftfreq(n, 1.0 / fs, dtype=torch.float64, device=device)
    tilt = (1.0 / torch.sqrt(1.0 + f / mix["tilt_hz"])).to(torch.complex64)
    white = torch.randn((len(srcs), b, n), generator=gen, device=device)
    for si, (spec, angles) in enumerate(srcs):
        tau = torch.as_tensor(delays(dist, ang, angles), device=device)
        for bi in range(b):
            s = torch.fft.rfft(white[si, bi]) * tilt
            shift = torch.exp(-2j * math.pi * f[None, :]
                              * tau[bi, :, None]).to(torch.complex64)
            x = torch.fft.irfft(s[None, :] * shift, n=n)          # (M, n)
            x *= spec["level"] / x[0].std()
            x *= envelope(n, fs, spec, 2 * math.pi * GOLDEN * (bi + si * b),
                          device)
            ring[:, bi] += x.reshape(m, slots, t * hop).transpose(0, 1)
    lead = mix["lead_in"]
    ring[0, :, :, :lead["hops"] * hop] *= lead["scale"]
    return Ring(ring, hop)
