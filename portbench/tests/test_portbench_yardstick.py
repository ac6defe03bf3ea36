"""The copied work counts reproduce chip_smoke.py's figures for row 3 at
the 30 s single-stream shape (18.39 Gflop, 131.6 MB)."""

import numpy as np
import torch

from portbench import yardstick
from portbench.reference import common


def bench_make_input(num_mics: int, seconds: float) -> np.ndarray:
    """chip_smoke.py's make_input (bench.py's): seeded noise with a quiet
    lead-in."""
    rng = np.random.default_rng(0)
    x = 0.1 * rng.standard_normal((num_mics, int(seconds * 48000)),
                                  dtype=np.float32)
    x[:, :12 * 1024] *= 1e-4
    return x


def test_row3_counts_at_the_30s_single_stream_shape():
    x = bench_make_input(16, 30)
    hop, nfft = 1024, 2048
    pad = -x.shape[1] % hop
    xx = np.concatenate([np.zeros((16, hop), np.float32), x,
                         np.zeros((16, pad), np.float32)], axis=1)
    freqs = common.half_freqs(nfft, 48000)
    ib = torch.as_tensor(common.band_bins(freqs, 100, 16000))
    spec = common.analysis(torch.as_tensor(xx)[None], hop,
                           common.sqrt_hann(nfft, "cpu"),
                           common.Precision("float64"))
    stat = common.gate_statistic(spec.index_select(-1, ib), nfft)[0]
    t, nib, m, w = stat.shape[0], len(ib), 16, 10
    pairs = int((stat > 0.001).sum())
    assert (t, nib) == (1407, 678)
    flops = yardstick.solve_flops(pairs, m, t, w, nib)
    nbytes = 8 * (t + w + 1) * m * nib + 9 * t * nib
    assert round(flops / 1e9, 2) == 18.39
    assert round(nbytes / 1e6, 1) == 131.6


def test_least_seconds_names_its_bound():
    kind = "NVIDIA H100 80GB HBM3"
    assert yardstick.least_seconds(kind, 3.35e12, 1.0) == (1.0, "bytes")
    assert yardstick.least_seconds(kind, 0.0, 67e12) == (1.0, "operations")
    assert yardstick.least_seconds("another card", 1.0, 1.0) is None
