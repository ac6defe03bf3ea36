"""Offline evaluation harness: scenes, alignment, separation metrics.

Counterpart of ``beamform_tpu/evaluation.py``, without JAX: the scenes and
the metrics are numpy on the host, the beamformer is any port model, on
the card or on the CPU. Only the model's ``process`` runs on its device;
its output comes to host numpy before any metric is computed.

The reference's verification story (SURVEY.md §4) is experimental: record the
beamformer output as WAV, replay mic1 through ``rosjack_ref`` for
sample-aligned comparison, compute SIR offline. This module is that story as
a library: synthesize controlled multichannel scenes (far-field point sources
with true geometric delays + noise), run any beamformer, align with the
``ref`` path, and report SNR/SIR improvements.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from beamform_tpu_torch.geometry import ArrayGeometry, steering_delays_np


@dataclass
class Scene:
    """A synthesized far-field scene with per-source ground truth."""

    mixture: np.ndarray          # (M, S) mic signals
    images: np.ndarray           # (num_sources, M, S) per-source mic images
    noise: np.ndarray            # (M, S)
    angles: Sequence[float]      # source DOAs (deg)
    sample_rate: int


def synth_scene(geom: ArrayGeometry, sources, angles, sample_rate: int,
                noise_std: float = 0.0, seed: int = 0,
                delay: str = "linear") -> Scene:
    """Far-field mixture: each source arrives at mic m with its geometric
    delay tau_m(angle).

    sources: list of (S,) arrays (same length).

    Both models produce image_m(t) = src(t - tau_m): a mic the wave reaches
    later sees the source delayed (tau as signed by util.h:157's
    cos(theta_m - theta)/(-c) convention — the same one the steering
    weights exp(-i 2 pi f tau) assume, so a beamformer steered at the true
    DOA phase-aligns the images exactly).

    delay:
      * ``"linear"`` — time-domain linear interpolation of the fractional
        delay: a slight low-pass/phase error at high frequencies, like a
        real resampling front-end.
      * ``"spectral"`` — exact frequency-domain fractional delay
        (rfft, multiply by exp(-i 2 pi f tau), irfft): the steering model
        and the scene agree exactly. Circular wrap at the block edge is
        negligible for sources with a quiet lead-in.
    """
    rng = np.random.default_rng(seed)
    m = geom.num_mics
    s = len(sources[0])
    images = np.zeros((len(sources), m, s))
    t = np.arange(s)
    for si, (src, ang) in enumerate(zip(sources, angles)):
        tau = steering_delays_np(geom, float(ang))
        if delay == "spectral":
            spec = np.fft.rfft(np.asarray(src, dtype=np.float64))
            f = np.fft.rfftfreq(s, 1.0 / sample_rate)
            for mi in range(m):
                images[si, mi] = np.fft.irfft(
                    spec * np.exp(-2j * np.pi * f * tau[mi]), n=s)
        elif delay == "linear":
            for mi in range(m):
                d = -tau[mi] * sample_rate      # src(t - tau): read ahead
                i0 = int(np.floor(d))
                frac = d - i0
                idx0 = np.clip(t + i0, 0, s - 1)
                idx1 = np.clip(t + i0 + 1, 0, s - 1)
                images[si, mi] = (1 - frac) * src[idx0] + frac * src[idx1]
        else:
            raise ValueError(f"unknown delay model {delay!r}")
    noise = noise_std * rng.standard_normal((m, s))
    return Scene(mixture=images.sum(axis=0) + noise, images=images,
                 noise=noise, angles=list(angles), sample_rate=sample_rate)


def align_to_ref(y: np.ndarray, hop: int) -> np.ndarray:
    """Undo the one-window WOLA latency: output sample s corresponds to
    input sample s - hop (util.h:276-278; the rosjack_ref alignment)."""
    return y[hop:]


def si_sdr(estimate: np.ndarray, target: np.ndarray) -> float:
    """Scale-invariant SDR (dB) of ``estimate`` against ``target``."""
    n = min(len(estimate), len(target))
    e, t = estimate[:n].astype(np.float64), target[:n].astype(np.float64)
    t = t - t.mean()
    e = e - e.mean()
    alpha = np.dot(e, t) / (np.dot(t, t) + 1e-12)
    s = alpha * t
    err = e - s
    return 10.0 * np.log10((np.dot(s, s) + 1e-12)
                           / (np.dot(err, err) + 1e-12))


def sir_db(estimate: np.ndarray, target_img: np.ndarray,
           interf_img: np.ndarray) -> float:
    """Signal-to-interference ratio by least-squares decomposition of the
    estimate onto the (mic0) target and interference images."""
    n = min(len(estimate), target_img.shape[-1], interf_img.shape[-1])
    e = estimate[:n].astype(np.float64)
    basis = np.stack([target_img[:n], interf_img[:n]]).astype(np.float64)
    coef, *_ = np.linalg.lstsq(basis.T, e, rcond=None)
    sig = coef[0] * basis[0]
    intf = coef[1] * basis[1]
    return 10.0 * np.log10((np.dot(sig, sig) + 1e-12)
                           / (np.dot(intf, intf) + 1e-12))


def _shifted_basis(img: np.ndarray, taps: int) -> np.ndarray:
    """(n, taps) matrix whose k-th column is ``img`` delayed by k samples
    (zero-filled head) — the allowed-distortion subspace of bss_eval."""
    n = len(img)
    cols = np.zeros((n, taps))
    for k in range(taps):
        cols[k:, k] = img[: n - k]
    return cols


def bss_project(estimate: np.ndarray, target_img: np.ndarray,
                interf_img: np.ndarray, taps: int = 1) -> dict:
    """bss_eval-style decomposition of ``estimate`` onto ``taps``-tap
    filtered copies of the target and interference images.

    A beamformer's WOLA path and per-bin weighting legitimately apply a
    short linear filter to the target; projecting onto single shifted
    copies only (taps=1, what :func:`sir_db` does) charges that filtering
    as error. With a modest distortion-filter allowance the metric
    matches the standard bss_eval convention:

    SIR = ||s_target||^2 / ||e_interf||^2,
    SDR = ||s_target||^2 / ||e_interf + e_artif||^2.
    """
    n = min(len(estimate), len(target_img), len(interf_img))
    e = estimate[:n].astype(np.float64)
    a = np.concatenate([_shifted_basis(target_img[:n], taps),
                        _shifted_basis(interf_img[:n], taps)], axis=1)
    coef, *_ = np.linalg.lstsq(a, e, rcond=None)
    s_tgt = a[:, :taps] @ coef[:taps]
    e_int = a[:, taps:] @ coef[taps:]
    e_art = e - s_tgt - e_int
    p_t = float(np.dot(s_tgt, s_tgt)) + 1e-12
    p_i = float(np.dot(e_int, e_int)) + 1e-12
    p_a = float(np.dot(e_art, e_art))
    return {
        "sir_db": 10.0 * np.log10(p_t / p_i),
        "sdr_db": 10.0 * np.log10(p_t / (p_i + p_a)),
    }


def evaluate_separation(model, scene: Scene, theta: float,
                        target_index: int = 0,
                        interf_index: Optional[int] = None,
                        skip: int = 0, taps: int = 1) -> dict:
    """Run a beamformer on a scene and report input/output SIR (dB).

    Input SIR is measured at mic0 of the mixture; output SIR on the
    latency-aligned beamformer output.

    skip: samples dropped from the head of the (aligned) output before
    scoring — a post-warmup scoring window for the adaptive models, whose
    cold covariances / filters need time to converge (the reference has the
    same warmup; it just never scores it).
    taps: distortion-filter length for the projection metrics. taps=1 is
    the strict single-delay decomposition; taps>1 adds bss_eval-style
    SIR/SDR with a short filter allowance (reported as sdr_db).
    """
    hop = model.engine.hop
    y = model.process(scene.mixture, theta).cpu().numpy()
    y = align_to_ref(y, hop)
    tgt = scene.images[target_index, 0]
    if interf_index is None:
        interf_index = 1 if len(scene.images) > 1 else 0
    itf = scene.images[interf_index, 0]
    ys, tgts, itfs = y[skip:], tgt[skip:len(y)], itf[skip:len(y)]
    sir_in = sir_db(scene.mixture[0][skip:], tgt[skip:], itf[skip:])
    sir_out = sir_db(ys, tgts, itfs)
    rep = {
        "sir_in_db": round(float(sir_in), 2),
        "sir_out_db": round(float(sir_out), 2),
        "sir_gain_db": round(float(sir_out - sir_in), 2),
        "si_sdr_db": round(float(si_sdr(ys, tgts)), 2),
    }
    if taps > 1:
        proj = bss_project(ys, tgts, itfs, taps)
        proj_in = bss_project(scene.mixture[0][skip:], tgt[skip:],
                              itf[skip:], taps)
        rep["sir_taps_db"] = round(proj["sir_db"], 2)
        rep["sir_taps_gain_db"] = round(proj["sir_db"] - proj_in["sir_db"],
                                        2)
        rep["sdr_taps_db"] = round(proj["sdr_db"], 2)
    return rep
