"""The yardstick: the chip's peaks and the operation and byte counts of
the port's kernels, copied from ``chip_smoke.py`` (``bound``,
``fft_flops``, ``solve_flops``, ``fused_bytes``, ``fused_fft_flops``) so
that no change to the program moves them."""

from __future__ import annotations

import math

#: published peaks of the SXM part at 700 W (dense float32 outside the
#: tensor cores; HBM3), by ``torch.cuda.get_device_name()``
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flop_per_s": 67e12},
}


def least_seconds(kind: str, nbytes: float, flops: float):
    """(least seconds of work that moves ``nbytes`` and does ``flops``
    float32 operations on a card of ``kind``, which bound sets it), or
    None for a card the table does not hold."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    t_b = nbytes / peak["bytes_per_s"]
    t_f = flops / peak["flop_per_s"]
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def fft_flops(n: int) -> float:
    """Operations of one complex n-point FFT, the usual 5 n log2 n."""
    return 5.0 * n * math.log2(n)


def solve_flops(pairs: int, m: int, t: int, w: int, nib: int,
                slots: int = 1, refine: bool = True, inner: int = 0) -> float:
    """Operations of the MVDR and LCMV solves over ``t`` frames after
    ``w`` history frames at ``nib`` bins, as few as the function needs.
    The window covariance slides, gate or not: each frame's outer product
    goes into the window sum and the epoch accumulator (10 operations per
    entry of the Hermitian triangle, M (M + 1) / 2 entries), and leaves
    the window W frames later (8). Each of the ``pairs`` gated (frame, bin)
    problems then takes the complex Cholesky factor (8/3 M^3), per
    constraint slot a forward and a backward solve (4 M^2 each; refinement
    adds a residual, 8 M^2, and a second pair), for LCMV the S x S inner
    system (the Hermitian G = C^H X, 4 S (S + 1) M; its Cholesky factor,
    4/3 S^3, and two solves, 8 S^2; w = X v, 8 S M), and y = w^H x."""
    tri = m * (m + 1) / 2
    cov = ((t + w) * 10 + t * 8) * nib * tri
    per = 8 / 3 * m ** 3 + slots * (3 if refine else 1) * 8 * m * m + 8 * m
    if inner:
        per += (4 * inner * (inner + 1) * m + 4 / 3 * inner ** 3
                + 8 * inner ** 2 + 8 * inner * m)
    return cov + pairs * per


def fused_bytes(m: int, t: int, hop: int, ctrl_elems: int,
                state_elems: int) -> int:
    """Bytes a fused call must move: the audio in (and its tail), the
    audio out (and the carry), the control planes, the complex state in
    and out, the per-frame indices."""
    return (4 * m * t * hop + 4 * m * hop + 4 * t * hop + 8 * hop
            + 8 * ctrl_elems + 16 * state_elems + 9 * t)


def fused_fft_flops(m: int, t: int, hop: int) -> float:
    """The analysis (one complex FFT per channel pair and frame, the
    window) and the synthesis (one FFT per frame, the window)."""
    n = 2 * hop
    return (-(-m // 2) + 1) * t * fft_flops(n) + (m + 1) * t * n


def analysis_work(c: int, t: int, hop: int, streams: int = 0):
    """(bytes, operations) of the WOLA analysis of ``c`` channels over
    ``t`` frames: the audio and tail in, the extended spectra out (and,
    with ``streams``, each stream's gate statistic); one complex FFT per
    channel pair and frame, the window."""
    n = 2 * hop
    nbytes = 4 * c * t * hop + 4 * c * hop + 8 * t * c * (hop + 2)
    if streams:
        nbytes += 4 * t * streams * (hop + 2)
    return nbytes, -(-c // 2) * t * fft_flops(n) + c * t * n


def synthesis_work(c: int, t: int, hop: int):
    """(bytes, operations) of the WOLA synthesis of ``c`` channels over
    ``t`` frames: the extended spectra and carry in, the audio and carry
    out; one FFT per channel and frame, the window."""
    n = 2 * hop
    return (8 * c * t * (hop + 2) + 8 * c * hop + 4 * c * t * hop,
            c * t * fft_flops(n) + c * t * n)
