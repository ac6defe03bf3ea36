"""Gate pairs that a float32 program may decide either way.

The energy gate compares a float32 statistic with a threshold. Where the
float64 statistic lies within a hair of the threshold, the program's
rounding may put the pair on the other side, and the pair's output (and
for GSS the bin's later demixing) follows the other branch. That is not
a fault. Each such pair is a *lane*: the few variants of one stream's
audio it allows, as the difference from the reference's own branch, over
the samples it reaches. ``choose`` takes, lane by lane, the variant
nearest to the program's audio; every pair away from the threshold is
held to the reference's branch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.reference.common import sqrt_hann

#: the statistic's relative distance from the threshold within which a
#: pair is ambiguous; float32 FFTs of these windows put the statistic
#: within ~1e-6 of its float64 value
MARGIN = 1e-4
#: at most this many ambiguous frames of one lane vary (2**MAX_FLIPS
#: variants); the rest keep the reference's branch
MAX_FLIPS = 4


@dataclass
class Lane:
    stream: int
    start: int                   # first sample of the chunk it reaches
    deltas: np.ndarray           # (V, n) audio differences from start on;
    #                              variant 0 is all zeros; samples past the
    #                              chunk's end are the carry's
    payload: list = field(default_factory=list)   # per variant, the node's


def bin_audio(dy: torch.Tensor, j: int, hop: int, amp: float) -> np.ndarray:
    """Audio of spectra that are zero but in bin ``j``: dy (V, F) complex
    per processed frame -> (V, (F+1)*hop) overlap-added samples (frame f's
    window at samples [f*hop, (f+2)*hop)), times ``amp``, float64."""
    v, f = dy.shape
    spec = torch.zeros((v, f, hop + 1), dtype=torch.complex128,
                       device=dy.device)
    spec[:, :, j] = dy.to(torch.complex128)
    p = torch.fft.irfft(spec, n=2 * hop, dim=-1) * sqrt_hann(2 * hop,
                                                              dy.device)
    out = torch.zeros((v, (f + 1) * hop), dtype=torch.float64,
                      device=dy.device)
    out[:, :f * hop] += p[:, :, :hop].reshape(v, -1)
    out[:, hop:] += p[:, :, hop:].reshape(v, -1)
    return (amp * out).cpu().numpy()


def choose(lanes, y_prog: np.ndarray, y_ref: np.ndarray):
    """Per lane, in order of the first sample it reaches, the variant
    whose audio lies nearest (least squares) to the program's; adds it to
    ``y_ref`` (B, S) in place. Returns the chosen variant of each lane."""
    s_len = y_ref.shape[1]
    chosen = [0] * len(lanes)
    for i in sorted(range(len(lanes)), key=lambda i: lanes[i].start):
        lane = lanes[i]
        n = min(lane.deltas.shape[1], s_len - lane.start)
        if n <= 0:
            continue
        seg = slice(lane.start, lane.start + n)
        diff = y_prog[lane.stream, seg] - y_ref[lane.stream, seg]
        err = ((diff[None, :] - lane.deltas[:, :n]) ** 2).sum(1)
        err = np.where(np.isfinite(err), err, np.inf)
        v = int(np.argmin(err))
        chosen[i] = v
        y_ref[lane.stream, seg] += lane.deltas[v, :n]
    return chosen


def carry_deltas(lanes, chosen, streams: int, s_len: int,
                 hop: int) -> np.ndarray:
    """(B, hop): the chosen variants' samples past the chunk's end (the
    overlap-add carry's part of their audio, times amp as they hold it)."""
    out = np.zeros((streams, hop))
    for lane, v in zip(lanes, chosen):
        k = s_len - lane.start
        if lane.deltas.shape[1] > k:
            out[lane.stream] += lane.deltas[v, k:k + hop]
    return out
