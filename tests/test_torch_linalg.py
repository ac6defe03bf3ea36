"""The Gauss-Jordan kernel's schedule (``csrc/linalg.cu``), transliterated in
numpy float32, against the two-matrix elimination it replaces, the port's
plain version and the JAX kernel in interpret mode.

The CUDA kernel eliminates in place: MP lanes (M rounded up to a power of
two, at least 4) hold one matrix, lane j holds column j of A until step j
and column j of the inverse from then on. At step i lane i's column is the
factor column that every lane reads (the broadcast), and it turns into the
inverse's column i. :func:`gj_lanes` runs that schedule lane by lane, with
the kernel's operations in the kernel's order, so that the CPU holds what
the card computes:

* at every step, each lane's column equals the matching live column of the
  two-matrix form (:func:`gj_two_matrix`, the Pallas kernel's arithmetic:
  A's columns past the step, the inverse's up to it) bit for bit, and the
  two-matrix form's other half is what the in-place form leaves out
  (unit columns of the inverse, exactly);
* the result is within 3e-6 of peak of the JAX kernel in interpret mode
  (the same products and sums in the same order, polish included, but each
  complex update fused into two FMAs a component where the JAX kernel
  rounds three times: 1.4e-6 at most on these inputs), and within 1e-5 of
  peak of ``kernels.linalg.gauss_jordan_inv`` (torch's complex division
  rounds differently from a conj(p) (1 / |p|^2));
* on a zero matrix and on matrices with a zero row and column (an exact
  zero pivot) the NaN positions equal the plain version's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beamform_tpu.kernels.linalg import gj_inverse_pallas
from beamform_tpu_torch.kernels import linalg as tl

F32 = np.float32
REL = 1e-5       # vs torch's plain version: the division rounds another way
JAX_REL = 3e-6   # vs the JAX kernel: the updates' FMAs, which it leaves unfused


def fma(a, b, c):
    """a b + c rounded once to float32, as the card's FFMA: the float32
    product is exact in float64, and the float64 sum, rounded to float32,
    differs from one rounding only at a double-rounding tie (about one
    operation in 2^29)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def cmsub(bx, by, fx, fy, px, py):
    """b - f p, two FMAs a component in the kernel's order (its cmsub)."""
    return (fma(fy, py, fma(-fx, px, bx)), fma(-fy, px, fma(-fx, py, by)))


def cmadd(ax, ay, xx, xy, tx, ty):
    """acc + x t, two FMAs a component in the kernel's order (its cmadd)."""
    return (fma(-xy, ty, fma(xx, tx, ax)), fma(xy, tx, fma(xx, ty, ay)))


def lanes_of(m: int) -> int:
    """MP: the kernel's lanes a matrix (csrc/linalg.cu's dispatch)."""
    return max(4, 1 << (m - 1).bit_length())


def gj_lanes(a: np.ndarray, polish: bool = False, trace=None):
    """The kernel's schedule on a (B, M, M) complex64 batch, in float32.

    Lane state is ``col[b, j, r]`` (lane j, row r) as separate real and
    imaginary float32 planes; lanes past M hold identity columns and steps
    past M are skipped, as on the card. ``trace`` (a list), if given,
    receives after each step (i, real, imag) of every lane."""
    b, m, _ = a.shape
    mp = lanes_of(m)
    cx = np.broadcast_to(np.eye(mp, dtype=F32), (b, mp, mp)).copy()
    cy = np.zeros((b, mp, mp), F32)
    cx[:, :m, :m] = np.swapaxes(a.real, 1, 2)
    cy[:, :m, :m] = np.swapaxes(a.imag, 1, 2)
    lane = np.arange(mp)
    for i in range(m):
        # the broadcast: lane i's column, as it stood before the step
        fx, fy = cx[:, i, :].copy(), cy[:, i, :].copy()
        px, py = fx[:, i, None], fy[:, i, None]
        inv_den = F32(1) / (px * px + py * py)
        me = lane == i
        ax = np.where(me, F32(1), cx[:, :, i])
        ay = np.where(me, F32(0), cy[:, :, i])
        p_x = (ax * px + ay * py) * inv_den
        p_y = (ay * px - ax * py) * inv_den
        for r in range(mp):
            if r == i:
                continue
            bx = np.where(me, F32(0), cx[:, :, r])
            by = np.where(me, F32(0), cy[:, :, r])
            cx[:, :, r], cy[:, :, r] = cmsub(bx, by, fx[:, r, None],
                                             fy[:, r, None], p_x, p_y)
        cx[:, :, i], cy[:, :, i] = p_x, p_y
        if trace is not None:
            trace.append((i, cx.copy(), cy.copy()))
    if polish:
        ar, ai = a.real.astype(F32), a.imag.astype(F32)
        # T = 2I - A X, lane j's column: sum over k of A[:, k] X[k][j]
        tx = np.broadcast_to(2 * np.eye(mp, dtype=F32), (b, mp, mp)).copy()
        ty = np.zeros((b, mp, mp), F32)
        for k in range(m):
            tx[:, :, :m], ty[:, :, :m] = cmsub(
                tx[:, :, :m], ty[:, :, :m],
                ar[:, None, :, k], ai[:, None, :, k],        # A[r][k]
                cx[:, :, k, None], cy[:, :, k, None])        # X[k][j], lane j
        # X T, lane j's column: sum over k of X[:, k] T[k][j], X broadcast
        ox = np.zeros((b, mp, mp), F32)
        oy = np.zeros((b, mp, mp), F32)
        for k in range(m):
            ox, oy = cmadd(ox, oy, cx[:, None, k, :], cy[:, None, k, :],
                           tx[:, :, k, None], ty[:, :, k, None])
        cx, cy = ox, oy
    return np.swapaxes(cx + 1j * cy, 1, 2)[:, :m, :m].astype(np.complex64)


def gj_two_matrix(a: np.ndarray, trace=None):
    """The two-matrix form (the Pallas kernel's, and the port's kernel
    before the in-place design) in float32 with the kernel's fused
    updates: A and the inverse side by side, both updated at every step.
    ``trace`` receives (i, mat, inv)."""
    m = a.shape[-1]
    mr, mi = a.real.astype(F32).copy(), a.imag.astype(F32).copy()
    orr = np.broadcast_to(np.eye(m, dtype=F32), a.shape).copy()
    oi = np.zeros(a.shape, F32)
    rows = np.arange(m)[:, None]
    for i in range(m):
        vr, vi = mr[:, i:i + 1, i:i + 1], mi[:, i:i + 1, i:i + 1]
        inv_den = F32(1) / (vr * vr + vi * vi)
        prr = (mr[:, i:i + 1] * vr + mi[:, i:i + 1] * vi) * inv_den
        pri = (mi[:, i:i + 1] * vr - mr[:, i:i + 1] * vi) * inv_den
        qrr = (orr[:, i:i + 1] * vr + oi[:, i:i + 1] * vi) * inv_den
        qri = (oi[:, i:i + 1] * vr - orr[:, i:i + 1] * vi) * inv_den
        piv = rows == i
        fr = np.where(piv, F32(0), mr[:, :, i:i + 1])
        fi = np.where(piv, F32(0), mi[:, :, i:i + 1])
        ur, ui = cmsub(mr, mi, fr, fi, prr, pri)
        mr, mi = np.where(piv, prr, ur), np.where(piv, pri, ui)
        ur, ui = cmsub(orr, oi, fr, fi, qrr, qri)
        orr, oi = np.where(piv, qrr, ur), np.where(piv, qri, ui)
        if trace is not None:
            trace.append((i, mr + 1j * mi, orr + 1j * oi))
    return (orr + 1j * oi).astype(np.complex64)


def hpd(rng, b, m):
    """Seeded Hermitian positive definite complex64 matrices, as the card
    tests make them."""
    x = rng.standard_normal((b, m, m)) + 1j * rng.standard_normal((b, m, m))
    return (x @ np.conj(np.swapaxes(x, 1, 2)) / m
            + 0.5 * np.eye(m)).astype(np.complex64)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("m", [1, 3, 16, 32])
def test_in_place_steps_hold_the_two_matrix_forms_live_columns(m):
    """After step i, lane j <= i holds the inverse's column j and lane j > i
    A's column j, each equal to the two-matrix form's bit for bit; the
    inverse's columns past i, which no lane holds, are still units."""
    a = hpd(np.random.default_rng(m), 5, m)
    lanes, two = [], []
    got = gj_lanes(a, trace=lanes)
    ref = gj_two_matrix(a, trace=two)
    np.testing.assert_array_equal(got, ref)
    eye = np.eye(m)
    for (i, cx, cy), (_, mat, inv) in zip(lanes, two):
        col = np.swapaxes(cx + 1j * cy, 1, 2)[:, :m, :m]  # [b, r, j]
        np.testing.assert_array_equal(col[:, :, :i + 1], inv[:, :, :i + 1])
        np.testing.assert_array_equal(col[:, :, i + 1:], mat[:, :, i + 1:])
        np.testing.assert_array_equal(
            inv[:, :, i + 1:],
            np.broadcast_to(eye[:, i + 1:], inv[:, :, i + 1:].shape))


@pytest.mark.parametrize("m", [1, 3, 16, 32])
@pytest.mark.parametrize("polish", [False, True])
def test_lane_schedule_matches_plain_and_the_jax_kernel(m, polish):
    a = hpd(np.random.default_rng(100 + m), 37, m)
    got = gj_lanes(a, polish)
    jx = np.asarray(gj_inverse_pallas(jnp.asarray(a), tile=64,
                                      interpret=True, polish=polish))
    assert _rel(got, jx) < JAX_REL
    plain = tl.gj_inverse_plain(torch.as_tensor(a), polish).numpy()
    assert _rel(got, plain) < REL
    f64 = np.linalg.inv(a.astype(np.complex128))
    assert _rel(got, f64) <= max(2 * _rel(plain, f64), 1e-6)


@pytest.mark.parametrize("m", [1, 3, 16, 32])
@pytest.mark.parametrize("polish", [False, True])
def test_lane_schedule_nan_positions_match_plain(m, polish):
    """A zero block (the cold-start covariance) and a block whose middle
    mic is silent (a zero row and column: an exact zero pivot at its step)
    give NaN exactly where the plain version does."""
    a = hpd(np.random.default_rng(200 + m), 6, m)
    a[:3] = 0
    a[3:, m // 2, :] = 0
    a[3:, :, m // 2] = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        got = gj_lanes(a, polish)
    plain = tl.gj_inverse_plain(torch.as_tensor(a), polish).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
    assert np.isnan(got).any()
