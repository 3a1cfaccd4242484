"""Fused-size transforms expressed as plain JAX ops.

Direct DFT matmul (n <= DIRECT_MAX) and the four-step factorization
(n <= FUSED_MAX) written as jnp ops and left to XLA to fuse and schedule,
plus the two stages of the staged large-N path (kernels/large.py).  Every
matmul names its precision (config.matmul_precision), so none falls to
TF32 by default.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import config
from ..config import KARATSUBA
from ..plan import FusedPlan

__all__ = [
    "fused_fft_jnp",
    "transform_axis0",
    "fused_fft_jnp_folded",
    "fused_fft_jnp_half",
    "fused_irfft_jnp",
    "irfft_direct_half_jnp",
    "stage_a_jnp",
    "stage_b_irfft_jnp",
    "stage_b_jnp",
    "stage_b_half_jnp",
]


def _prec():
    # Trace-time lookup so GPU_FFT_TPU_PRECISION (config.PRECISION) governs
    # every matmul in this module; see config.matmul_precision.
    return config.matmul_precision()


def _dot(a, b):
    return jnp.dot(a, b, precision=_prec(), preferred_element_type=jnp.float32)


def _cmatmul(ar, ai, t, prefix):
    """Split-complex matmul against the plan's table group ``prefix``."""
    fr, fi = t[prefix + "r"], t[prefix + "i"]
    if KARATSUBA:
        k1 = _dot(ar + ai, fr)
        k2 = _dot(ar, t[prefix + "d"])
        k3 = _dot(ai, t[prefix + "s"])
        return k1 - k3, k1 + k2
    return _dot(ar, fr) - _dot(ai, fi), _dot(ar, fi) + _dot(ai, fr)


def fused_fft_jnp(xr, xi, plan: FusedPlan):
    """One fused transform over a (B, n) batch, as jnp ops.

    Semantics identical to ``fused.fused_fft``: ``xi`` may be None (real
    input), output is split-complex in natural order, unnormalized.
    """
    b, n = xr.shape
    assert n == plan.n, (n, plan.n)
    t = plan.tables

    if plan.kind == "direct":
        if xi is None:
            return _dot(xr, t["fr"]), _dot(xr, t["fi"])
        return _cmatmul(xr, xi, t, "f")

    n1, n2 = plan.n1, plan.n2
    xtr = jnp.swapaxes(xr.reshape(b, n1, n2), 1, 2).reshape(b * n2, n1)
    if xi is None:
        pr = _dot(xtr, t["f1r"])
        pi = _dot(xtr, t["f1i"])
    else:
        xti = jnp.swapaxes(xi.reshape(b, n1, n2), 1, 2).reshape(b * n2, n1)
        pr, pi = _cmatmul(xtr, xti, t, "f1")
    p3r = pr.reshape(b, n2, n1)
    p3i = pi.reshape(b, n2, n1)
    zr = p3r * t["twr"] - p3i * t["twi"]
    zi = p3r * t["twi"] + p3i * t["twr"]
    qr = jnp.swapaxes(zr, 1, 2).reshape(b * n1, n2)
    qi = jnp.swapaxes(zi, 1, 2).reshape(b * n1, n2)
    rr, ri = _cmatmul(qr, qi, t, "f2")
    yr = jnp.swapaxes(rr.reshape(b, n1, n2), 1, 2).reshape(b, n)
    yi = jnp.swapaxes(ri.reshape(b, n1, n2), 1, 2).reshape(b, n)
    return yr, yi


def fused_fft_jnp_folded(xr, xi, plan: FusedPlan):
    """Fused four-step with the digit reversal folded into the output
    permutation of the final einsum — ZERO explicit transposes.

    Same math and tables as :func:`fused_fft_jnp` (stage 1 contracts the
    major digit a via 'bac,ak->bck'; stage 2 contracts c via
    'bck,cJ->bJk', whose output order IS the natural spectrum).  The
    dispatch in kernels/large.py chooses between the two forms per (B, n)
    (plan.use_folded_layout).
    """
    b, n = xr.shape
    assert n == plan.n and plan.kind == "fourstep", (n, plan.n, plan.kind)
    n1, n2 = plan.n1, plan.n2
    t = plan.tables

    def cm(eq, ar, ai, prefix):
        if KARATSUBA:
            k1 = jnp.einsum(eq, ar + ai, t[prefix + "r"], precision=_prec())
            k2 = jnp.einsum(eq, ar, t[prefix + "d"], precision=_prec())
            k3 = jnp.einsum(eq, ai, t[prefix + "s"], precision=_prec())
            return k1 - k3, k1 + k2
        rr = jnp.einsum(eq, ar, t[prefix + "r"], precision=_prec())
        ri = jnp.einsum(eq, ai, t[prefix + "i"], precision=_prec())
        sr = jnp.einsum(eq, ar, t[prefix + "i"], precision=_prec())
        si = jnp.einsum(eq, ai, t[prefix + "r"], precision=_prec())
        return rr - ri, sr + si

    x3 = xr.reshape(b, n1, n2)  # [b, a, c]
    if xi is None:
        pr = jnp.einsum("bac,ak->bck", x3, t["f1r"], precision=_prec())
        pi = jnp.einsum("bac,ak->bck", x3, t["f1i"], precision=_prec())
    else:
        pr, pi = cm("bac,ak->bck", x3, xi.reshape(b, n1, n2), "f1")
    twr = t["twr"][None]  # (n2, n1) = [c, k1]
    twi = t["twi"][None]
    zr = pr * twr - pi * twi
    zi = pr * twi + pi * twr
    rr, ri = cm("bck,cJ->bJk", zr, zi, "f2")
    return rr.reshape(b, n), ri.reshape(b, n)


def stage_b_jnp(yr, yi, n1: int, n2: int, t: dict):
    """Stage B of the staged large-N path: row FFTs of length n2 = m1*m2
    with the global digit reversal FOLDED INTO the final einsum's output
    permutation ('bkcj,cJ->bJjk').

    Leaving the digit reversal as a separate jnp.swapaxes costs a full HBM
    transpose pass; expressing it as the dot's output order lets XLA assign
    layouts so the natural-order output falls out of the last matmul.

    ``yr, yi``: (B, n1, n2) stage-A output.  Returns split-complex (B, n)
    natural-order spectra.  Row digits: position = a1*m2 + a2, output
    k2 = j1 + m1*j2; global flat index k = k1 + n1*j1 + n1*m1*j2.
    """
    b = yr.shape[0]
    m1, m2 = t["m1"], t["m2"]
    zr = yr.reshape(b, n1, m1, m2)
    zi = yi.reshape(b, n1, m1, m2)

    def cm(eq, xr_, xi_, prefix):
        if KARATSUBA:
            k1 = jnp.einsum(eq, xr_ + xi_, t[prefix + "r"], precision=_prec())
            k2 = jnp.einsum(eq, xr_, t[prefix + "d"], precision=_prec())
            k3 = jnp.einsum(eq, xi_, t[prefix + "s"], precision=_prec())
            return k1 - k3, k1 + k2
        pr = jnp.einsum(eq, xr_, t[prefix + "r"], precision=_prec())
        pi = jnp.einsum(eq, xi_, t[prefix + "i"], precision=_prec())
        qr = jnp.einsum(eq, xr_, t[prefix + "i"], precision=_prec())
        qi = jnp.einsum(eq, xi_, t[prefix + "r"], precision=_prec())
        return pr - pi, qr + qi

    # Stage 1: contract a1 -> j1, keep [b, k1, a2, j1].
    pr, pi = cm("bkac,aj->bkcj", zr, zi, "f1")
    twr = t["twr"][None, None]  # (m2, m1) = [a2, j1]
    twi = t["twi"][None, None]
    wr = pr * twr - pi * twi
    wi = pr * twi + pi * twr
    # Stage 2: contract a2 -> j2; output order [b, j2, j1, k1] IS the
    # natural-order spectrum when flattened.
    rr, ri = cm("bkcj,cJ->bJjk", wr, wi, "f2")
    n = n1 * n2
    return rr.reshape(b, n), ri.reshape(b, n)


def _hermitian_mirror(sr, si, n1: int, axis: int):
    """Full-spectrum (.., n1, ..) arrays from half-spectrum (.., h, ..) ones.

    A real-input transform's spectrum is Hermitian: X[n-k] = conj(X[k]).
    With flat output index k = k1 + n1*j, the complement n - k =
    (n1 - k1) + n1*(n2 - 1 - j) for k1 in [1, n1) — the j part is a PURE
    reversal (digits complement independently, no carries), so the missing
    k1' in [h, n1) half is an axis-reversal + conjugate of the computed
    k1 = n1 - k1' in [1, n1/2] half.  ``axis`` carries k1 (a MAJOR axis
    here, so the concat is cheap); every OTHER non-batch axis of ``sr/si``
    must be a j-digit axis, reversed together (rev of each digit == rev of
    flat j).  Returns (.., n1, ..) arrays ready for the final digit-reversal
    transpose.
    """
    from jax import lax

    h = n1 // 2 + 1
    rev_axes = tuple(range(1, sr.ndim))  # all non-batch axes (k1 + j digits)
    idx = [slice(None)] * sr.ndim
    idx[axis] = slice(1, h)
    tail_r = lax.rev(sr[tuple(idx)], rev_axes)
    tail_i = -lax.rev(si[tuple(idx)], rev_axes)
    idx[axis] = slice(0, h - 1)
    head = tuple(idx)
    return (
        jnp.concatenate([sr[head], tail_r], axis),
        jnp.concatenate([si[head], tail_i], axis),
    )


def transform_axis0(xr, xi, n: int, sign: int, scale: float | None = None):
    """Length-n transform along axis -2 of (..., n, w) — IN PLACE of the
    transpose -> row transform -> transpose-back composition.

    The column pass of a 2-D transform (ops/fft2d.py) is the only consumer
    of an axis-0 transform; expressing it as the same four-step
    contractions with the width as a FREE TRAILING axis
    ('acw,ak->ckw' then 'ckw,cJ->Jkw', digit reversal folded into the
    output order exactly like fused_fft_jnp_folded) deletes all four
    transpose passes of the transpose form (gate: plan.axis0_applies).

    ``xi`` may be None (real input).  Same tables/plan as the row engines
    (plan.get_fused_plan(n, sign, wide=False)); unnormalized, natural
    order along the transformed axis.  Pow2 ``n <= FUSED_MAX`` only —
    callers fall back to the transpose form otherwise.
    """
    from ..plan import get_fused_plan

    lead = xr.shape[:-2]
    h, w = xr.shape[-2], xr.shape[-1]
    assert h == n, (h, n)
    x3r = xr.reshape((-1,) + xr.shape[-2:])
    x3i = None if xi is None else xi.reshape((-1,) + xi.shape[-2:])
    plan = get_fused_plan(n, sign, wide=False, scale=scale)  # scale in tables
    t = plan.tables

    if plan.kind == "direct":
        # One contraction over the column axis; F is symmetric so the
        # row-engine tables apply unchanged.
        if x3i is None:
            yr = jnp.einsum("bhw,hk->bkw", x3r, t["fr"], precision=_prec())
            yi = jnp.einsum("bhw,hk->bkw", x3r, t["fi"], precision=_prec())
        else:
            yr, yi = _ceinsum("bhw,hk->bkw", x3r, x3i, t, "f")
        return yr.reshape(lead + (h, w)), yi.reshape(lead + (h, w))

    n1, n2 = plan.n1, plan.n2
    x4r = x3r.reshape(-1, n1, n2, w)
    if x3i is None:
        pr = jnp.einsum("bacw,ak->bckw", x4r, t["f1r"], precision=_prec())
        pi = jnp.einsum("bacw,ak->bckw", x4r, t["f1i"], precision=_prec())
    else:
        x4i = x3i.reshape(-1, n1, n2, w)
        pr, pi = _ceinsum("bacw,ak->bckw", x4r, x4i, t, "f1")
    twr = t["twr"][None, :, :, None]  # (n2, n1) = [c, k]
    twi = t["twi"][None, :, :, None]
    zr = pr * twr - pi * twi
    zi = pr * twi + pi * twr
    rr, ri = _ceinsum("bckw,cJ->bJkw", zr, zi, t, "f2")
    return rr.reshape(lead + (h, w)), ri.reshape(lead + (h, w))


def _ceinsum(eq, ar, ai, t, prefix):
    """Split-complex einsum against the plan's table group ``prefix``
    (the einsum twin of _cmatmul, same Karatsuba 3-dot form)."""
    if KARATSUBA:
        k1 = jnp.einsum(eq, ar + ai, t[prefix + "r"], precision=_prec())
        k2 = jnp.einsum(eq, ar, t[prefix + "d"], precision=_prec())
        k3 = jnp.einsum(eq, ai, t[prefix + "s"], precision=_prec())
        return k1 - k3, k1 + k2
    rr = jnp.einsum(eq, ar, t[prefix + "r"], precision=_prec())
    ii = jnp.einsum(eq, ai, t[prefix + "i"], precision=_prec())
    ri = jnp.einsum(eq, ar, t[prefix + "i"], precision=_prec())
    ir = jnp.einsum(eq, ai, t[prefix + "r"], precision=_prec())
    return rr - ii, ri + ir


def fused_fft_jnp_half(xr, plan: FusedPlan):
    """Real-input fused four-step computing only k1 <= n1/2, mirroring the rest.

    The spectrum of a real signal is Hermitian, and in the transpose-form
    four-step the k1 digit is a batch-major row axis from the twiddle on —
    so slicing to h = n1/2 + 1 rows halves the second matmul stage AND both
    remaining transposes, then one cheap rev+concat epilogue reconstructs
    the full spectrum (unlike the packed rfft, this form reindexes nothing
    until the final mirror).  Valid for either sign; requires real input.
    """
    b, n = xr.shape
    assert plan.kind == "fourstep", plan.kind
    n1, n2 = plan.n1, plan.n2
    t = plan.tables
    h = n1 // 2 + 1
    xtr = jnp.swapaxes(xr.reshape(b, n1, n2), 1, 2).reshape(b * n2, n1)
    # Trace-time column slice of the stage-1 tables: XLA does not narrow
    # the dot through a post-hoc output slice, so only the h kept k1
    # columns are computed explicitly.
    pr = _dot(xtr, t["f1r"][:, :h])
    pi = _dot(xtr, t["f1i"][:, :h])
    p3r = pr.reshape(b, n2, h)
    p3i = pi.reshape(b, n2, h)
    twr = t["twr"][:, :h]  # (n2, n1) sliced to the kept half
    twi = t["twi"][:, :h]
    zr = p3r * twr - p3i * twi
    zi = p3r * twi + p3i * twr
    qr = jnp.swapaxes(zr, 1, 2).reshape(b * h, n2)
    qi = jnp.swapaxes(zi, 1, 2).reshape(b * h, n2)
    rr, ri = _cmatmul(qr, qi, t, "f2")
    f_r, f_i = _hermitian_mirror(
        rr.reshape(b, h, n2), ri.reshape(b, h, n2), n1, axis=1
    )
    yr = jnp.swapaxes(f_r, 1, 2).reshape(b, n)
    yi = jnp.swapaxes(f_i, 1, 2).reshape(b, n)
    return yr, yi


def stage_b_half_jnp(yr, yi, n1: int, n2: int, t: dict):
    """Real-input stage B: k1 <= n1/2 slice + Hermitian mirror epilogue.

    Same math and tables as :func:`stage_b_jnp`, but the k1 batch axis is
    sliced to h = n1/2 + 1 rows (the k1 = 0 and k1 = n1/2 self-conjugate
    columns are computed directly, so there is no special case), the final
    einsum emits its native output order 'bkjJ' (the folded 'bJjk' order
    would put the odd-sized h axis minor), and one explicit half-sized
    transpose performs the digit reversal after the mirror.
    """
    b = yr.shape[0]
    h = n1 // 2 + 1
    m1, m2 = t["m1"], t["m2"]
    zr = yr[:, :h, :].reshape(b, h, m1, m2)
    zi = yi[:, :h, :].reshape(b, h, m1, m2)

    def cm(eq, xr_, xi_, prefix):
        if KARATSUBA:
            k1 = jnp.einsum(eq, xr_ + xi_, t[prefix + "r"], precision=_prec())
            k2 = jnp.einsum(eq, xr_, t[prefix + "d"], precision=_prec())
            k3 = jnp.einsum(eq, xi_, t[prefix + "s"], precision=_prec())
            return k1 - k3, k1 + k2
        pr = jnp.einsum(eq, xr_, t[prefix + "r"], precision=_prec())
        pi = jnp.einsum(eq, xi_, t[prefix + "i"], precision=_prec())
        qr = jnp.einsum(eq, xr_, t[prefix + "i"], precision=_prec())
        qi = jnp.einsum(eq, xi_, t[prefix + "r"], precision=_prec())
        return pr - pi, qr + qi

    pr, pi = cm("bkac,aj->bkcj", zr, zi, "f1")
    twr = t["twr"][None, None]
    twi = t["twi"][None, None]
    wr = pr * twr - pi * twi
    wi = pr * twi + pi * twr
    s_r, s_i = cm("bkcj,cJ->bkjJ", wr, wi, "f2")  # (b, h, m1, m2)
    f_r, f_i = _hermitian_mirror(s_r, s_i, n1, axis=1)  # (b, n1, m1, m2)
    n = n1 * n2
    out_r = jnp.transpose(f_r, (0, 3, 2, 1)).reshape(b, n)
    out_i = jnp.transpose(f_i, (0, 3, 2, 1)).reshape(b, n)
    return out_r, out_i


def fused_irfft_jnp(xr, xi, plan: dict):
    """Real-output inverse of a full Hermitian spectrum, Hermitian-FOLDED.

    The dual of :func:`fused_fft_jnp_half`: instead of computing half the
    spectrum and mirroring, fold the conjugate half of the INPUT before the
    matmuls.  With the spectrum as a (n2, n1) grid (flat k = k1 + n1*k2),
    column n1-k1 is a conjugate k2-reversal of column k1, so

        x[m1*n2 + m2] = Re( sum_{k1=0}^{n1/2} c_k1 * w_{n1}^{m1 k1}
                            * w_n^{m2 k1} * G[k1, m2] ) * scale,
        G[k1, m2] = sum_{k2} X[k1 + n1*k2] * w_{n2}^{m2 k2},

    (c and scale folded into the plan tables).  Costs: stage 1 reads and
    contracts only h1 = n1/2 + 1 grid columns (half); the twiddle acts on
    half; stage 2 needs only the REAL part — two real einsums over an
    n1/2-deep contraction plus a rank-1 Nyquist broadcast — and its
    'bkm,kM->bMm' output order IS the natural-order signal (zero
    transposes, zero mirror).  ~2.7x fewer FLOPs than the full inverse.

    ``xr, xi``: (B, n) full split-complex Hermitian spectrum (only the
    k1 <= n1/2 grid columns are read — XLA dead-code-eliminates the rest
    of any producer that feeds this directly).  Returns the (B, n) real
    signal.  Correct ONLY for Hermitian input (real-signal spectra).
    """
    b, n = xr.shape
    n1, n2, h1 = plan["n1"], plan["n2"], plan["h1"]
    assert n == n1 * n2, (n, n1, n2)
    gr = xr.reshape(b, n2, n1)[:, :, :h1]  # [b, k2, k1]
    gi = xi.reshape(b, n2, n1)[:, :, :h1]
    return _irfft_fold_core(gr, gi, plan)


def fused_irfft_half_jnp(xr, xi, plan: dict):
    """Real-output inverse DIRECTLY from the one-sided (B, h) spectrum.

    Same contraction as :func:`fused_irfft_jnp`, but the (B, n2, h1) fold
    grid g[k2, k1] = X[k1 + n1*k2] is assembled straight from the
    h = n/2 + 1 given bins instead of materializing the full Hermitian
    mirror and reading half of it back (the mirror's rev + two concats
    cost ~4 elementwise passes over n — about 2 us of the 5.3 us
    irfft_n65536 row before this path existed).  The construction is the
    fused-size analog of :func:`irfft_fold_columns`: with
    L[k2, k1] = X[k1 + n1*k2] for k2 < n2/2 (all within the given half,
    since k1 <= n1/2 implies flat k < n/2),

      * rows k2 <  n2/2:          g = L[:, :h1] — a slice;
      * rows k2 >= n2/2, k1 >= 1: X[n - k] = conj(X[(n1-k1) + n1(n2-1-k2)])
        — a 2-D rev of L's upper-k1 half, conjugated;
      * rows k2 >  n2/2, k1 = 0:  conj(L[n2-k2, 0]) — a rev of the
        block-start column; k2 = n2/2, k1 = 0 is the Nyquist bin X[n/2].

    DC/Nyquist imaginary parts are zeroed here (numpy ``irfft``
    semantics).  ``xr, xi``: (B, h).  Returns the (B, n) real signal.
    """
    from jax import lax

    b = xr.shape[0]
    n1, n2, h1 = plan["n1"], plan["n2"], plan["h1"]
    n = n1 * n2
    half = n // 2
    assert xr.shape[-1] == half + 1, (xr.shape, n)
    xi = xi.at[..., 0].set(0.0).at[..., half].set(0.0)
    lr = xr[:, :half].reshape(b, n2 // 2, n1)
    li = xi[:, :half].reshape(b, n2 // 2, n1)
    lo_r = lr[:, :, :h1]
    lo_i = li[:, :, :h1]
    # k2 >= n2/2, k1 in [1, n1/2]: rev over (k2', k1') of the k1 >= n1/2
    # half — a two-axis reversal.
    hi_r = lax.rev(lr[:, :, n1 // 2 :], (1, 2))
    hi_i = -lax.rev(li[:, :, n1 // 2 :], (1, 2))
    # k1 = 0 column of the mirrored rows: Nyquist first (k2 = n2/2), then
    # block starts k2'' = n2/2 - 1 .. 1 reversed.
    q0_r = jnp.concatenate(
        [xr[:, half:], lax.rev(lr[:, 1:, 0], (1,))], axis=1
    )[..., None]
    q0_i = jnp.concatenate(
        [xi[:, half:], -lax.rev(li[:, 1:, 0], (1,))], axis=1
    )[..., None]
    gr = jnp.concatenate([lo_r, jnp.concatenate([q0_r, hi_r], axis=2)], axis=1)
    gi = jnp.concatenate([lo_i, jnp.concatenate([q0_i, hi_i], axis=2)], axis=1)
    return _irfft_fold_core(gr, gi, plan)


def _irfft_fold_core(gr, gi, plan: dict):
    """The fold contraction shared by the full- and one-sided entries:
    ``gr, gi`` is the (B, n2, h1) grid of kept k1 <= n1/2 columns."""
    b = gr.shape[0]
    n1, n2 = plan["n1"], plan["n2"]
    n = n1 * n2

    def cm(eq, ar, ai, prefix):
        if KARATSUBA:
            k1 = jnp.einsum(eq, ar + ai, plan[prefix + "r"], precision=_prec())
            k2 = jnp.einsum(eq, ar, plan[prefix + "d"], precision=_prec())
            k3 = jnp.einsum(eq, ai, plan[prefix + "s"], precision=_prec())
            return k1 - k3, k1 + k2
        pr = jnp.einsum(eq, ar, plan[prefix + "r"], precision=_prec())
        pi = jnp.einsum(eq, ai, plan[prefix + "i"], precision=_prec())
        qr = jnp.einsum(eq, ar, plan[prefix + "i"], precision=_prec())
        qi = jnp.einsum(eq, ai, plan[prefix + "r"], precision=_prec())
        return pr - pi, qr + qi

    # Stage 1: contract k2 -> m2; k1 rides a major row axis, m2 minor.
    gr_m, gi_m = cm("bck,cm->bkm", gr, gi, "g2")  # (b, h1, n2)
    twr = plan["twr"][None]  # (h1, n2) = [k1, m2]
    twi = plan["twi"][None]
    zr = gr_m * twr - gi_m * twi
    zi = gr_m * twi + gi_m * twr
    # Stage 2: contract k1 in [0, n1/2) — real part only, natural order out.
    half = n1 // 2
    out = jnp.einsum(
        "bkm,kM->bMm", zr[:, :half, :], plan["w1r"], precision=_prec()
    ) - jnp.einsum("bkm,kM->bMm", zi[:, :half, :], plan["w1i"], precision=_prec())
    # Nyquist (k1 = n1/2) column: stage-2 factor is scale * (-1)^m1 (real).
    out = out + plan["alt"][None, :, None] * zr[:, half, :][:, None, :]
    return out.reshape(b, n)


def irfft_direct_half_jnp(xr, xi, plan: dict):
    """Direct real-output inverse from the ONE-SIDED spectrum: two real
    matmuls against the Hermitian-folded (h, n) tables
    (``plan.get_irfft_direct_plan`` — c_k fold weights and scale live in
    the tables; the k = 0 / n/2 sin rows are exactly zero, so DC/Nyquist
    imaginary parts are ignored for free).  ``xr, xi``: (B, h) with
    h = n//2 + 1.  Returns the (B, n) real signal."""
    return _dot(xr, plan["cr"]) + _dot(xi, plan["ci"])


def rfft_direct_packed_jnp(x, plan: dict):
    """One-dot direct real forward from the packed table
    (``plan.get_rfft_direct_packed_plan``): returns the PACKED (B, n)
    product — columns [0, h) = Re, [h, n) = Im[1..h-1] — plus the split
    one-sided pair.  PSD-type consumers should reduce the packed form
    directly (``rfft_packed_psd_jnp``) and skip the unpack concat."""
    out = _dot(x, plan["t"])
    h = plan["h"]
    b = x.shape[0]
    zero = jnp.zeros((b, 1), out.dtype)
    fr = out[:, :h]
    fi = jnp.concatenate([zero, out[:, h:], zero], axis=-1)
    return out, fr, fi


def rfft_packed_psd_jnp(x, plan: dict):
    """One-sided |X|^2 straight from the packed one-dot forward: re² from
    columns [0, h), im² folded in from columns [h, n) — no unpack pass."""
    out = _dot(x, plan["t"])
    h = plan["h"]
    sq = out * out
    return sq[:, :h].at[:, 1 : h - 1].add(sq[:, h:])


def irfft_direct_half_k128_jnp(xr, xi, plan: dict):
    """Lane-exact direct half inverse: K = n/2 dots + Nyquist broadcast.

    Same math as :func:`irfft_direct_half_jnp` but the h = n/2 + 1 deep
    contraction is split into K = n/2 dots plus the rank-1 Nyquist term
    ``xr[:, -1:] * alt``, which XLA fuses into the dot epilogue
    (``plan.get_irfft_direct_k128_plan``)."""
    return (
        _dot(xr[:, :-1], plan["cr"])
        + _dot(xi[:, :-1], plan["ci"])
        + xr[:, -1:] * plan["alt"]
    )


def stage_b_irfft_jnp(yr, yi, n1: int, t: dict):
    """Real-output stage B for the staged inverse: per-row Hermitian fold.

    ``yr, yi``: (B, n1, n2) post-twiddle stage-A output of a HERMITIAN
    spectrum's staged inverse (sign +1).  Each k1 row is itself Hermitian
    over n2 — Z[k1, n2-c] = conj(Z[k1, c]) exactly (phase proof in
    plan.py:get_stage_b_irfft_plan) — so stage B applies the fused-size
    fold (:func:`fused_irfft_jnp`) per row with the fold digit on the row
    layout's minor axis: stage 1 contracts the m1 digit over only
    h = 65 of the 128 minor-digit columns, the twiddle acts on half, and
    stage 2 is two real einsums whose ``bKqm,qM->bMmK`` output order IS
    the globally digit-reversed natural order (K = the stage-A k1 digit
    rides the minor output axis; zero transposes), plus the rank-1
    Nyquist broadcast.  ``t`` is ``plan.get_stage_b_irfft_plan(n, scale)``
    — scale and the c_q fold weights live in the ``w1``/``alt`` tables.

    Returns the (B, n) REAL signal, natural order.
    """
    Q, P = t["n1"], t["n2"]  # Q = 128 fold digit (minor), P = m1
    b = yr.shape[0]
    gr = yr.reshape(b, n1, P, Q)[..., : t["h1"]]  # [b, K, p, q]
    gi = yi.reshape(b, n1, P, Q)[..., : t["h1"]]
    return stage_b_irfft_from_half(gr, gi, t)


def irfft_fold_columns(zr, zi, t: dict):
    """Build the fold's (B, n1, P, h) input from HALF the stage-A columns.

    ``zr, zi``: (B, n1, W) — the first W >= n2/2 + 1 post-twiddle stage-A
    columns (``large._stage_a(..., cols=W)``).  The remaining columns are
    conjugate mirrors — Z[k1, n2-c] = conj(Z[k1, c]) exactly (phase proof
    in plan.py:get_stage_b_irfft_plan) — so the p >= P/2 blocks of the
    fold input g[p, q] = Z[p*Q + q], q <= Q/2, reconstruct as pure
    axis-reversals of the computed range:

      q in [1, Q/2]: g[p, q] = conj(Z[(P-1-p)*Q + (Q-q)]) — a 2-D rev over
        (p, q) of the computed blocks' upper-q half;
      q = 0:         g[p, 0] = conj(Z[(P-p)*Q]) — a rev of the block-start
        plane shifted by one block (sources c = Q..(P/2)*Q <= n2/2, all
        within the computed range).

    This is what lets the real-output staged inverse skip ~half the
    stage-A programs — the dominant cost of the staged path.
    """
    from jax import lax

    b, n1 = zr.shape[0], zr.shape[1]
    Q, P, h = t["n1"], t["n2"], t["h1"]
    ph = P // 2
    assert zr.shape[2] >= ph * Q + 1, (zr.shape, P, Q)
    blk_r = zr[:, :, : ph * Q].reshape(b, n1, ph, Q)
    blk_i = zi[:, :, : ph * Q].reshape(b, n1, ph, Q)
    lo_r = blk_r[..., :h]
    lo_i = blk_i[..., :h]
    # p >= P/2, q in [1, Q/2]: rev over (p', q') of the q' in (Q/2, Q) half.
    hi_r = lax.rev(blk_r[..., Q - h + 1 :], (2, 3))
    hi_i = -lax.rev(blk_i[..., Q - h + 1 :], (2, 3))
    # p >= P/2, q = 0: sources Z[(P-p)*Q] = block starts p'' in [1, P/2]
    # reversed; the p'' = P/2 start is column n2/2 itself.
    q0_r = jnp.concatenate(
        [blk_r[:, :, 1:, 0], zr[:, :, ph * Q : ph * Q + 1]], axis=2
    )  # (b, n1, ph) block starts p'' = 1..P/2
    q0_i = jnp.concatenate([blk_i[:, :, 1:, 0], zi[:, :, ph * Q : ph * Q + 1]], axis=2)
    q0_r = lax.rev(q0_r, (2,))[..., None]
    q0_i = -lax.rev(q0_i, (2,))[..., None]
    gr = jnp.concatenate([lo_r, jnp.concatenate([q0_r, hi_r], axis=3)], axis=2)
    gi = jnp.concatenate([lo_i, jnp.concatenate([q0_i, hi_i], axis=3)], axis=2)
    return gr, gi


def stage_b_irfft_from_half(gr, gi, t: dict):
    """The fold contraction on a pre-built (B, n1, P, h) input; see
    :func:`stage_b_irfft_jnp` (which builds the input by slicing a full
    stage-A output) and :func:`irfft_fold_columns` (which builds it from
    half the columns)."""
    b, n1 = gr.shape[0], gr.shape[1]
    Q, P = t["n1"], t["n2"]

    def cm(eq, ar, ai, prefix):
        if KARATSUBA:
            k1 = jnp.einsum(eq, ar + ai, t[prefix + "r"], precision=_prec())
            k2 = jnp.einsum(eq, ar, t[prefix + "d"], precision=_prec())
            k3 = jnp.einsum(eq, ai, t[prefix + "s"], precision=_prec())
            return k1 - k3, k1 + k2
        pr = jnp.einsum(eq, ar, t[prefix + "r"], precision=_prec())
        pi = jnp.einsum(eq, ai, t[prefix + "i"], precision=_prec())
        qr = jnp.einsum(eq, ar, t[prefix + "i"], precision=_prec())
        qi = jnp.einsum(eq, ai, t[prefix + "r"], precision=_prec())
        return pr - pi, qr + qi

    # Stage 1: contract the major row digit p -> m over the kept half.
    gr_m, gi_m = cm("bKpq,pm->bKqm", gr, gi, "g2")  # (b, n1, h, P)
    twr = t["twr"][None, None]  # (h, P) = [q, m]
    twi = t["twi"][None, None]
    zr = gr_m * twr - gi_m * twi
    zi = gr_m * twi + gi_m * twr
    # Stage 2: contract q in [0, Q/2), REAL part only; output order
    # [b, M, m, K] flattens to the global natural order k = K + n1*(M*P+m).
    half = Q // 2
    out = jnp.einsum(
        "bKqm,qM->bMmK", zr[:, :, :half, :], t["w1r"], precision=_prec()
    ) - jnp.einsum("bKqm,qM->bMmK", zi[:, :, :half, :], t["w1i"], precision=_prec())
    # Nyquist (q = Q/2): stage-2 factor is scale * (-1)^M, a real rank-1
    # broadcast of the (b, K, P) Nyquist slice.
    nyq = jnp.transpose(zr[:, :, half, :], (0, 2, 1))  # (b, P, n1) = [b, m, K]
    out = out + t["alt"][None, :, None, None] * nyq[:, None, :, :]
    return out.reshape(b, n1 * P * Q)


def stage_a_jnp(x3r, x3i, plan: dict):
    """Stage A of the staged large-N path: column DFT + twiddle.

    ``x3*``: (B, n1, n2) views; x3i may be None.  The column DFT is an
    einsum contracting the n1 axis (a left matmul per batch element).
    Accepts either the factored twiddle (the production plan layout — the
    full table is reconstructed here as a jnp op, which XLA fuses into the
    twiddle multiply) or a materialized (n1, n2) pair.
    """
    f1r, f1i = plan["f1r"], plan["f1i"]
    if "two_r" in plan:
        n1 = f1r.shape[0]
        o_r = jnp.asarray(plan["two_r"])[:, :, None]  # (n1, n2/ct, 1)
        o_i = jnp.asarray(plan["two_i"])[:, :, None]
        i_r = jnp.asarray(plan["twi_r"])[:, None, :]  # (n1, 1, ct)
        i_i = jnp.asarray(plan["twi_i"])[:, None, :]
        n2 = plan["two_r"].shape[1] * plan["twi_r"].shape[1]
        twr = (o_r * i_r - o_i * i_i).reshape(n1, n2)
        twi = (o_r * i_i + o_i * i_r).reshape(n1, n2)
    else:
        twr, twi = plan["twr"], plan["twi"]
    pr = jnp.einsum("ka,bac->bkc", f1r, x3r, precision=_prec())
    pi = jnp.einsum("ka,bac->bkc", f1i, x3r, precision=_prec())
    if x3i is not None:
        pr = pr - jnp.einsum("ka,bac->bkc", f1i, x3i, precision=_prec())
        pi = pi + jnp.einsum("ka,bac->bkc", f1r, x3i, precision=_prec())
    return pr * twr - pi * twi, pr * twi + pi * twr
