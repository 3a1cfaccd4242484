"""Large-N transforms: staged four-step factorization at the JAX level.

The reference handles growing N with more outer radix-4 dispatches
(``src/fft.rs:93-127``) and tops out its benchmarks at N = 65,536.  Here,
transforms beyond FUSED_MAX run STAGED over the (n1, n2) matrix view of the
signal: stage A is the column DFT plus the large-N twiddle (a LEFT matmul,
so the column digit never moves), stage B the row transforms of length n2
with the output digit reversal folded into the last einsum's output order.
This extends coverage to MAX_N = 2^24.

Every stage is plain ``jnp``/``lax`` that XLA fuses and schedules:

* fused sizes (n <= FUSED_MAX): the four-step einsum graph
  (kernels/fused_jnp.py);
* stage A: :func:`kernels.fused_jnp.stage_a_jnp`, a batched GEMM plus the
  twiddle reconstructed from its factored tables in one elementwise fusion;
* stage B: :func:`kernels.fused_jnp.stage_b_jnp`, the einsum four-step with
  the digit reversal as the final dot's output permutation, so no separate
  transpose pass over the whole array is needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import DIRECT_MAX, FUSED_MAX
from ..plan import (
    get_fused_plan,
    get_irfft_plan,
    get_pack_tables,
    get_stage_a_plan,
    half_spectrum_applies,
    irfft_half_applies,
    irfft_half_staged_applies,
    rfft_pack_applies,
    use_folded_layout,
    wide_split_applies,
)
from .fused_jnp import (
    fused_fft_jnp,
    fused_fft_jnp_folded,
    fused_fft_jnp_half,
    fused_irfft_jnp,
    stage_a_jnp,
    stage_b_half_jnp,
    stage_b_jnp,
)

__all__ = ["transform_any", "inverse_real", "inverse_real_half"]


def _stage_a(x3r, x3i, plan, rows=None, cols=None):
    """Stage A over (B, n1, n2) views: column DFT + twiddle.

    ``rows`` keeps only the first k1 rows (the f1 and twiddle tables are
    sliced at trace time, so the GEMM itself shrinks); ``cols`` keeps only
    the first ``cols`` columns, a multiple of the plan's column tile ``ct``
    (stage A is column-local, so the input and the outer twiddle factor
    are sliced instead of the output).
    """
    if rows is not None:
        plan = dict(plan)
        for k in ("f1r", "f1i", "two_r", "two_i", "twi_r", "twi_i"):
            plan[k] = plan[k][:rows]
    if cols is not None:
        ct = plan["ct"]
        plan = dict(plan)
        plan["two_r"] = plan["two_r"][:, : cols // ct]
        plan["two_i"] = plan["two_i"][:, : cols // ct]
        x3r = x3r[:, :, :cols]
        x3i = None if x3i is None else x3i[:, :, :cols]
    return stage_a_jnp(x3r, x3i, plan)


def inverse_real(xr, xi, n: int, scale: float | None = None):
    """Real-output inverse transform of a HERMITIAN (B, n) spectrum.

    The real-output dual of ``transform_any(xr, None, ...)``'s real-input
    paths: every consumer that inverts a real signal's spectrum (irfft,
    convolution/filtering epilogues, istft) discards the imaginary part,
    so for n >= tuning.irfft_half_min the conjugate half of the INPUT is
    folded before the matmuls (kernels/fused_jnp.py:fused_irfft_jnp) —
    half the stage-1 contraction, real-only stage 2, natural output order.
    Below the gate this falls back to ``transform_any`` + drop imag.

    Unnormalized unless ``scale`` is given (1/n for numpy irfft
    semantics); at folded sizes the scale lives in the plan tables (zero
    extra passes).  Correct ONLY for Hermitian input — garbage in the
    conjugate half silently changes the answer rather than erroring.
    """
    if n <= FUSED_MAX and n >= 16 and irfft_half_applies(n):
        return fused_irfft_jnp(xr, xi, get_irfft_plan(n, scale=scale))
    if n > FUSED_MAX and irfft_half_staged_applies(n):
        from ..plan import get_stage_b_irfft_plan

        bt = get_stage_b_irfft_plan(n, scale=scale)
        if bt is not None:
            from .fused_jnp import irfft_fold_columns, stage_b_irfft_from_half

            b = xr.shape[0]
            plan = get_stage_a_plan(n, +1)
            n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
            # Hermitian input makes the post-twiddle stage-A output itself
            # conjugate-symmetric over columns (Z[k1, n2-c] = conj(Z[k1, c]),
            # phase proof in plan.get_stage_b_irfft_plan), so stage A — the
            # dominant staged cost — runs on only the first ceil((n2/2+1)/ct)
            # column tiles and the rest reconstruct as cheap axis-reversals
            # (kernels/fused_jnp.py:irfft_fold_columns).
            cols = -(-(n2 // 2 + 1) // ct) * ct
            yr, yi = _stage_a(
                xr.reshape(b, n1, n2), xi.reshape(b, n1, n2), plan, cols=cols
            )
            g_r, g_i = irfft_fold_columns(yr, yi, bt)
            # Per-row Hermitian fold stage B: half the stage-1 contraction,
            # real-only stage 2, digit reversal folded into the output order.
            return stage_b_irfft_from_half(g_r, g_i, bt)
    yr, _ = transform_any(xr, xi, n, +1, scale=scale)
    return yr


def inverse_real_half(xr, xi, n: int, scale: float | None = None):
    """Real-output inverse from the ONE-SIDED (B, h = n//2 + 1) spectrum.

    The entry point for consumers that hold rfft-style half spectra
    (irfft_device, istft).  At direct sizes (n <= DIRECT_MAX) the Hermitian
    symmetry folds into the DFT tables themselves: two real matmuls with
    contraction h — half the FLOPs of the mirror + full-inverse form and
    no mirror pass.  Larger n: cheap rev+concat Hermitian reconstruction +
    :func:`inverse_real`, whose fold dispatch reads back only the
    k1 <= n1/2 grid columns at fold sizes (so XLA dead-code-eliminates most
    of the mirror).  DC/Nyquist imaginary parts are ignored (numpy
    ``irfft`` semantics) on every path.
    """
    h = n // 2 + 1
    if xr.shape[-1] != h:
        raise ValueError(f"inverse_real_half expects {h} bins for n={n}, got {xr.shape[-1]}")
    if n <= DIRECT_MAX:
        from ..plan import get_irfft_direct_k128_plan, get_irfft_direct_plan
        from ..tuning import get_tuning

        from .fused_jnp import irfft_direct_half_jnp, irfft_direct_half_k128_jnp

        if n >= 256 and get_tuning().irfft_direct_k128:
            # K = n/2 dots + the rank-1 Nyquist broadcast instead of one
            # h = n/2 + 1 deep contraction (tuning.irfft_direct_k128).
            return irfft_direct_half_k128_jnp(xr, xi, get_irfft_direct_k128_plan(n, scale))
        return irfft_direct_half_jnp(xr, xi, get_irfft_direct_plan(n, scale))
    # Hermitian reconstruction: X[n-k] = conj(X[k]); DC/Nyquist forced real.
    # The tail rev(x[1:h-1]) equals the first h-2 elements of the flat
    # reversal of x[:n/2], written as a two-axis reversal of a (rows, 128)
    # view.  (Assembling the fold grid straight from the one-sided bins,
    # fused_jnp.fused_irfft_half_jnp, is the alternative form.)
    from jax import lax

    xi = xi.at[..., 0].set(0.0).at[..., h - 1].set(0.0)
    half = n // 2
    b = xr.shape[0]
    rows = max(half // 128, 1)

    def rev_half(a):
        return lax.rev(a[..., :half].reshape(b, rows, -1), (1, 2)).reshape(b, half)

    full_r = jnp.concatenate([xr, rev_half(xr)[..., : half - 1]], axis=-1)
    full_i = jnp.concatenate([xi, -rev_half(xi)[..., : half - 1]], axis=-1)
    return inverse_real(full_r, full_i, n, scale=scale)


def transform_any(xr, xi, n: int, sign: int, scale: float | None = None):
    """Split-complex transform of each row of a (B, n) batch, any pow2 n >= 2.

    ``xi`` may be None (real input).  Unnormalized unless ``scale`` is
    given (e.g. 1/n for a normalized inverse) — at fused sizes the scale
    is folded into the last matmul's table (zero extra HBM passes; exact
    for power-of-two scales); the staged path applies it as an epilogue.
    Natural output order.
    """
    if xi is None and sign == -1 and n >= 8 and rfft_pack_applies(xr.shape[0], n):
        return _real_packed_fft(xr, n, scale)
    if n <= FUSED_MAX:
        b = xr.shape[0]
        if xi is None and half_spectrum_applies(n):
            # Real input at big fused sizes: compute only the k1 <= n1/2
            # spectrum half and mirror the rest (Hermitian symmetry, valid
            # for either sign) — halves the second matmul and both trailing
            # transposes.  The gate (tuning.half_spectrum_min) is above the
            # wide-split region, so the balanced transpose-form split is
            # always the right base here; ``scale`` folds into the plan's
            # f2 tables like the full-spectrum forms.
            plan = get_fused_plan(n, sign, wide=False, scale=scale)
            if plan.kind == "fourstep":
                return fused_fft_jnp_half(xr, plan)
        # Split and layout choices are the shared predicates in plan.py
        # (single source of truth with describe_plan): wide batches take
        # the n2 = 128 split; the folded layout (digit reversal as the
        # final einsum's output permutation, zero transposes) is used
        # except for single/double-signal big n.
        plan = get_fused_plan(n, sign, wide=wide_split_applies(b, n), scale=scale)
        if plan.kind == "fourstep" and use_folded_layout(b, n):
            return fused_fft_jnp_folded(xr, xi, plan)
        return fused_fft_jnp(xr, xi, plan)

    if scale is not None:
        # Staged sizes: explicit epilogue (the fused-size table fold does
        # not reach the stage-A tables).
        yr, yi = transform_any(xr, xi, n, sign)
        s = jnp.float32(scale)
        return yr * s, yi * s

    # Staged sizes: both autodiff modes run the same staged dispatch.  The
    # transform is a SYMMETRIC complex-linear map (DFT matrix: F^T = F), so
    # the real-form transpose is conj . T . conj — the same transform on
    # the conjugated cotangent — instead of XLA's transpose of the einsum
    # tangent graph.  linear_call makes the tangent pass f itself and the
    # transpose the conjugated call, so jvp, vjp and grad all run the
    # forward dispatch.  linear_call has no vmap rule; the API is already
    # batched over rows, so vmap over a staged transform is unsupported —
    # fold extra axes into B instead.
    if xi is None:
        # x real: M = [Re F; Im F], so M^T [cr; ci] = Re(F_sign(cr - i*ci)).
        return jax.custom_derivatives.linear_call(
            lambda _, x: _staged(x, None, n, sign),
            lambda _, ct: _staged(ct[0], -ct[1], n, sign)[0],
            (),
            xr,
        )

    def _transpose(_, ct):
        gr, gi = _staged(ct[0], -ct[1], n, sign)
        return gr, -gi

    return jax.custom_derivatives.linear_call(
        lambda _, x: _staged(x[0], x[1], n, sign), _transpose, (), (xr, xi)
    )


def _staged(xr, xi, n: int, sign: int):
    """The staged (n > FUSED_MAX) dispatch body; see transform_any."""
    b = xr.shape[0]
    plan = get_stage_a_plan(n, sign)
    n1, n2 = plan["n1"], plan["n2"]
    x3r = xr.reshape(b, n1, n2)
    x3i = None if xi is None else xi.reshape(b, n1, n2)
    half = xi is None and half_spectrum_applies(n) and plan["stage_b"] is not None

    # Stage A: Y[k1, c] = sum_a F1[k1, a] x[a, c] * W_n^(k1*c).  With real
    # input and the half-spectrum stage B, the stage-A output is conjugate-
    # symmetric over k1 (S[n1-k1, c] = conj(S[k1, c])) and stage_b_half_jnp
    # reads only k1 <= n1/2, so only those n1/2 + 1 rows are computed.
    yr, yi = _stage_a(x3r, x3i, plan, rows=n1 // 2 + 1 if half else None)

    if plan["stage_b"] is not None:
        if half:
            # Real input: k1 <= n1/2 slice + Hermitian mirror epilogue —
            # halves stage B's matmuls and the digit-reversal transpose.
            return stage_b_half_jnp(yr, yi, n1, n2, plan["stage_b"])
        # Stage B with the digit reversal folded into the final einsum's
        # output permutation — no separate HBM transpose pass.
        return stage_b_jnp(yr, yi, n1, n2, plan["stage_b"])

    # Stage B: row DFTs of length n2 (k1-major rows are already contiguous).
    rr, ri = transform_any(yr.reshape(b * n1, n2), yi.reshape(b * n1, n2), n2, sign)

    # Output digit reversal: flat index k = k1 + n1*k2.
    out_r = jnp.swapaxes(rr.reshape(b, n1, n2), 1, 2).reshape(b, n)
    out_i = jnp.swapaxes(ri.reshape(b, n1, n2), 1, 2).reshape(b, n)
    return out_r, out_i


def _real_packed_fft(xr, n: int, scale):
    """Length-n real forward FFT as ONE length-n/2 complex FFT + O(n) epilogue.

    The classic real-input packing: z[j] = x[2j] + i*x[2j+1] (a static
    stride-2 reshape — no gather), Z = FFT_{n/2}(z), then the exact
    recombination

        E[k] = (Z[k] + conj(Z[-k])) / 2        (spectrum of the evens)
        O[k] = -i*(Z[k] - conj(Z[-k])) / 2     (spectrum of the odds)
        X[k]       = E[k] + W_n^k * O[k]
        X[k + n/2] = E[k] - W_n^k * O[k]

    Halving the transform length halves every matmul stage's FLOPs; the
    optional ``scale`` (a normalized forward) folds into the half/twiddle
    factors.  The even/odd split is a (256, 256) 0/1 permutation matmul on
    block-local views (plan.deinterleave_matrix) followed by two aligned
    slices; the mirrored index is a reversal of a (rows, 128) view over
    both trailing axes.  The gate (tuning.rfft_pack_min) is closed.
    """
    from jax import lax

    from ..plan import deinterleave_matrix

    b = xr.shape[0]
    h = n // 2
    # Even/odd split: block-local permutation matmul, then aligned slices
    # reassemble the global z = x[0::2] + i*x[1::2].
    perm = deinterleave_matrix()
    xp = jnp.dot(
        xr.reshape(b * (n // 256), 256),
        perm,
        precision=lax.Precision.HIGHEST,  # exact: P is 0/1
        preferred_element_type=jnp.float32,
    ).reshape(b, n // 256, 256)
    zr = xp[:, :, :128].reshape(b, h)
    zi = xp[:, :, 128:].reshape(b, h)
    Zr, Zi = transform_any(zr, zi, h, -1)
    # Mirrored index m(k) = (h - k) mod h = roll(reverse(Z), 1); the
    # reversal runs on a (rows, 128) view over BOTH trailing axes, which
    # equals the flat reversal.
    rows = max(h // 128, 1)
    Zr_m = jnp.roll(lax.rev(Zr.reshape(b, rows, -1), (1, 2)).reshape(b, h), 1, axis=1)
    Zi_m = jnp.roll(lax.rev(Zi.reshape(b, rows, -1), (1, 2)).reshape(b, h), 1, axis=1)
    hs = jnp.float32(0.5 if scale is None else 0.5 * scale)
    wr, wi = get_pack_tables(n)
    wrs, wis = wr * hs, wi * hs  # trace-time constant fold
    Er = (Zr + Zr_m) * hs
    Ei = (Zi - Zi_m) * hs
    O2r = Zi + Zi_m  # 2*Re(O); the 1/2 lives in the scaled twiddle
    O2i = Zr_m - Zr  # 2*Im(O)
    Tr = wrs * O2r - wis * O2i
    Ti = wrs * O2i + wis * O2r
    out_r = jnp.concatenate([Er + Tr, Er - Tr], axis=1)
    out_i = jnp.concatenate([Ei + Ti, Ei - Ti], axis=1)
    return out_r, out_i
