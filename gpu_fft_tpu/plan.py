"""Transform planning: factorization and cached device-resident tables.

The reference specializes one compiled kernel per (n, stage, direction,
batch) tuple via CubeCL comptime parameters and relies on CubeCL's kernel
cache (reference ``README.md:407-409``).  The analog here is a *plan*: for each
(n, direction) we factor the transform, build the f64-accurate DFT/twiddle
tables once (kernels/tables.py), push them to device, and cache the whole
bundle.  ``jax.jit`` then specializes the compiled executable per input shape
exactly like CubeCL's comptime cache — first call compiles (~seconds, like the
reference's documented ~50 ms/variant shader warm-up, ``README.md:87-89``),
later calls hit the cache.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .config import DIRECT_MAX, FUSED_MAX, MAX_N
from .kernels.tables import dft_matrix_ext, twiddle_table
from .tuning import get_tuning

__all__ = ["FusedPlan", "get_fused_plan", "balanced_split", "describe_plan"]


# ── Shared dispatch predicates ───────────────────────────────────────────────
# Single source of truth for the per-(B, n) selection; used by BOTH the
# real dispatch (kernels/large.py) and describe_plan, so the introspection
# can never drift from reality.  The constants live in the per-device
# tuning table (tuning.py).


def wide_split_applies(b: int, n: int) -> bool:
    """Wide batches use the n2 = 128 split (tuning.wide_*)."""
    t = get_tuning()
    return b >= t.wide_batch_min and t.wide_n_min <= n <= t.wide_n_max


def use_folded_layout(b: int, n: int) -> bool:
    """Folded layout (digit reversal in the final einsum's output
    permutation) except at single/double-signal big n (tuning.folded_*)."""
    t = get_tuning()
    return n <= t.folded_n_max or b >= t.folded_batch_min


def rfft_pack_applies(b: int, n: int) -> bool:
    """Real-input packing: compute the length-n real forward transform as
    ONE length-n/2 complex transform plus an O(n) recombination.

    Halves every matmul stage's FLOPs at the price of extra elementwise
    passes for the recombination (tuning.rfft_pack_min; the gate is
    closed).
    """
    return n >= get_tuning().rfft_pack_min


def irfft_half_applies(n: int) -> bool:
    """Real-OUTPUT inverse transforms fold the Hermitian half of the input
    spectrum BEFORE the matmuls (X[n-k] = conj(X[k]) makes the k1 > n1/2
    grid columns exact conjugate k2-reversals of the kept ones, so their
    stage contributions are conjugates and out = Re(sum over k1 <= n1/2)).

    Halves the first matmul stage AND reads only half the spectrum; the
    second stage needs only the REAL part — two real matmuls instead of
    four — with the natural output order falling out of the einsum (zero
    transposes, zero mirror).  ~2.7x FLOP cut vs the full complex inverse.
    """
    return n >= get_tuning().irfft_half_min


def irfft_half_staged_applies(n: int) -> bool:
    """Staged real-output inverses run half-column stage A + the per-row
    stage-B fold from this size up (tuning.irfft_half_staged_min; at 2^17
    the column-tile granularity leaves stage A whole)."""
    return n >= get_tuning().irfft_half_staged_min


def axis0_applies(h: int, w: int) -> bool:
    """Whether the 2-D column pass runs as axis-0 folded einsums
    (kernels/fused_jnp.py:transform_axis0) instead of
    transpose -> row transform -> transpose back.

    Closed in every tuning row (tuning.axis0_*)."""
    t = get_tuning()
    return (
        h & (h - 1) == 0
        and t.axis0_h_min <= h <= t.axis0_h_max
        and w >= t.axis0_w_min
        and h > w // 2
    )


def half_spectrum_applies(n: int) -> bool:
    """Real-input transforms compute only the k1 <= n1/2 spectrum half and
    mirror the rest (Hermitian symmetry: X[n-k] = conj(X[k]) for real input,
    either sign).

    Unlike the packed-rfft trick, this slices the k1 digit AFTER the
    twiddle, where it is a batch-major row axis — halving the second matmul
    stage and the trailing transposes with zero reindexing until one cheap
    rev+concat mirror epilogue (tuning.half_spectrum_min).
    """
    return n >= get_tuning().half_spectrum_min


@functools.lru_cache(maxsize=None)
def get_pack_tables(n: int) -> tuple:
    """Recombination tables for the real-input packed forward transform.

    ``(wr, wi)``: W_n^k for k < n/2 (f64-generated f32), consumed by
    ``kernels/large.py:_real_packed_fft``.
    """
    from .kernels.tables import unit_roots

    return unit_roots(n // 2, n, -1)


@functools.lru_cache(maxsize=None)
def deinterleave_matrix() -> np.ndarray:
    """(256, 256) 0/1 permutation: block-local even/odd separation.

    Right-multiplying a (rows, 256) view sends each row's even elements to
    columns 0..127 and odds to 128..255: a stride-2 deinterleave written as
    an exact 0/1 matmul (used by the packed rfft and the Makhoul DCT
    permutation).
    """
    p = np.zeros((256, 256), dtype=np.float32)
    for src in range(256):
        dst = src // 2 + (128 if src % 2 else 0)
        p[src, dst] = 1.0
    return p


def fused_split(n: int, b: int) -> tuple[int, int]:
    """The (n1, n2) factorization a (b, n) fused transform will use."""
    if wide_split_applies(b, n):
        return max(2, n // 128), min(128, n // 2)
    return balanced_split(n)


def balanced_split(n: int) -> tuple[int, int]:
    """Split power-of-two n into (n1, n2), n1 <= n2, n1 * n2 = n.

    A balanced split minimizes both the matmul FLOPs (N * (n1 + n2) complex
    MACs) and the table footprint (n1^2 + n2^2 + n1*n2 complex entries), and
    keeps both contraction dimensions as large as possible.
    """
    if n & (n - 1):
        raise ValueError(f"balanced_split requires a power of two, got {n}")
    m = n.bit_length() - 1
    n1 = 1 << (m // 2)
    return n1, n // n1


@dataclass(frozen=True)
class FusedPlan:
    """Everything needed to run one fused transform of length ``n``.

    kind:
      * ``direct``   — X = x @ F_n, one complex matmul (n <= DIRECT_MAX).
      * ``fourstep`` — n = n1 * n2 factorization, two matmul passes plus a
        pointwise twiddle (n <= FUSED_MAX), XLA-scheduled
        (kernels/fused_jnp.py).
    ``sign`` is -1 for forward, +1 for inverse (unnormalized).
    """

    n: int
    sign: int
    kind: str
    n1: int
    n2: int
    tables: dict[str, Any] = field(compare=False, hash=False)


@functools.lru_cache(maxsize=None)
def get_fused_plan(n: int, sign: int, wide: bool = False, scale: float | None = None) -> FusedPlan:
    """``wide=True`` selects the wide-batch split (n2 = 128): a 128-deep
    contraction in the dominant second matmul instead of the FLOP-minimizing
    balanced split, for batches that supply enough rows
    (plan.wide_split_applies).

    ``scale`` (e.g. the inverse's 1/n) is folded into the LAST matmul's
    table, so normalized transforms cost zero extra HBM passes.  Exact in
    f32 for power-of-two scales (the only ones the library uses)."""
    if n & (n - 1) or n < 2:
        raise ValueError(f"fused plans require power-of-two n >= 2, got {n}")
    if n > FUSED_MAX:
        raise ValueError(f"n={n} exceeds FUSED_MAX={FUSED_MAX}; use the large-N path")
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")

    k = np.float32(1.0) if scale is None else np.float32(scale)

    if n <= DIRECT_MAX:
        fr, fi, fs, fd = dft_matrix_ext(n, sign)
        # Tables are cached as NumPy arrays: jit lifts them into the traced
        # program as device-resident constants, and caching device/tracer
        # objects across traces would leak tracers.  The sum/diff variants
        # feed the 3-multiplication complex matmul (config.KARATSUBA).
        tables = {"fr": fr * k, "fi": fi * k, "fs": fs * k, "fd": fd * k}
        return FusedPlan(n=n, sign=sign, kind="direct", n1=n, n2=1, tables=tables)

    if wide and n >= 256:
        n1, n2 = max(2, n // 128), min(128, n // 2)
    else:
        n1, n2 = balanced_split(n)
    f1r, f1i, f1s, f1d = dft_matrix_ext(n1, sign)
    f2r, f2i, f2s, f2d = dft_matrix_ext(n2, sign)
    # Twiddle oriented (n2, n1): applied to the intermediate indexed
    # [n2, k1] right after the column DFT (see kernels/fused_jnp.py).
    twr, twi = twiddle_table(n2, n1, n, sign)
    tables = {
        "f1r": f1r, "f1i": f1i, "f1s": f1s, "f1d": f1d,
        "f2r": f2r * k, "f2i": f2i * k, "f2s": f2s * k, "f2d": f2d * k,
        "twr": twr, "twi": twi,
    }
    return FusedPlan(n=n, sign=sign, kind="fourstep", n1=n1, n2=n2, tables=tables)


@functools.lru_cache(maxsize=None)
def get_irfft_plan(
    n: int, scale: float | None = None, split: tuple[int, int] | None = None
) -> dict:
    """Tables for the real-output Hermitian-fold inverse (fused sizes).

    Math (kernels/fused_jnp.py:fused_irfft_jnp): with the spectrum viewed
    as a (n2, n1) grid (flat k = k1 + n1*k2), Hermitian symmetry makes
    column n1-k1 a conjugate k2-reversal of column k1, so the k1 > n1/2
    terms of x[m1*n2 + m2] = (1/n) sum w_{n1}^{m1 k1} w_n^{m2 k1} G[k1, m2]
    are conjugates of the kept ones and the output is
    Re(sum_{k1<=n1/2} c_k1 * ...), c_0 = c_{n1/2} = 1, else 2.

    Tables (all sign +1, f64-generated):
      * ``g2*``  — (n2, n2) DFT contracting k2 -> m2 (+ Karatsuba variants).
      * ``twr/twi`` — (h1, n2) twiddle w_n^{+k1 m2}, h1 = n1/2 + 1.
      * ``w1r/w1i`` — (n1/2, n1) final stage w_{n1}^{+m1 k1} with the
        c_k1 weights AND ``scale`` folded in; rows k1 in [0, n1/2) keep the
        contraction a power of two (the Nyquist row is the rank-1 ``alt``
        term instead).
      * ``alt`` — (n1,) scale * (-1)^m1: the k1 = n1/2 Nyquist column's
        stage-2 factor is real, so its contribution is a rank-1 broadcast.

    ``split`` overrides the balanced (n1, n2) factorization — n1 is the
    FOLD digit (the minor digit of the flat index).  The staged stage-B
    fold passes (m2, m1) = (128, n2/128) so the fold digit matches the
    row layout's minor digit (get_stage_b_irfft_plan).
    """
    if n & (n - 1) or n < 16:
        raise ValueError(f"irfft plans require power-of-two n >= 16, got {n}")
    if n > FUSED_MAX:
        raise ValueError(f"n={n} exceeds FUSED_MAX={FUSED_MAX}")
    if split is None:
        n1, n2 = balanced_split(n)
    else:
        n1, n2 = split
        if n1 * n2 != n or n1 < 4 or n1 & (n1 - 1) or n2 & (n2 - 1):
            raise ValueError(f"bad irfft split {split} for n={n}")
    h1 = n1 // 2 + 1
    k = 1.0 if scale is None else float(scale)
    g2r, g2i, g2s, g2d = dft_matrix_ext(n2, +1)
    twr, twi = twiddle_table(h1, n2, n, +1)
    half = n1 // 2
    red = np.mod(
        np.outer(np.arange(half, dtype=np.int64), np.arange(n1, dtype=np.int64)), n1
    ).astype(np.float64)
    ang = (2.0 * np.pi / n1) * red
    c = np.full((half, 1), 2.0 * k)
    c[0] = k
    w1r = (np.cos(ang) * c).astype(np.float32)
    w1i = (np.sin(ang) * c).astype(np.float32)
    alt = (k * (-1.0) ** np.arange(n1, dtype=np.float64)).astype(np.float32)
    return {
        "n1": n1, "n2": n2, "h1": h1,
        "g2r": g2r, "g2i": g2i, "g2s": g2s, "g2d": g2d,
        "twr": twr, "twi": twi, "w1r": w1r, "w1i": w1i, "alt": alt,
    }


@functools.lru_cache(maxsize=None)
def get_irfft_direct_plan(n: int, scale: float | None = None) -> dict:
    """Tables for the DIRECT half-input real-output inverse (n <= DIRECT_MAX).

    For a Hermitian spectrum given by its one-sided h = n//2 + 1 bins,
    x[m] = Re(sum_k X[k] w_n^{+km}) folds into c_k weights
    (c_0 = c_{n/2} = 1, else 2), so the whole inverse is TWO real matmuls
    against (h, n) tables:

        x = xr @ cr + xi @ ci,   cr[k, m] = s*c_k*cos(2*pi*k*m/n),
                                 ci[k, m] = -s*c_k*sin(2*pi*k*m/n)

    — contraction h instead of n (half the FLOPs of the full inverse) and
    no Hermitian-mirror pass at all.  The sin rows at k = 0 and k = n/2 are exactly
    zero (angles reduced mod n in int64 first), so stray imaginary parts in
    the DC/Nyquist bins are ignored — numpy ``irfft`` semantics — with no
    masking pass.  ``scale`` (e.g. 1/n) folds into the tables: zero extra
    HBM passes.
    """
    if n & (n - 1) or n < 2:
        raise ValueError(f"direct irfft plans require power-of-two n >= 2, got {n}")
    if n > DIRECT_MAX:
        raise ValueError(f"n={n} exceeds DIRECT_MAX={DIRECT_MAX}; use the fold path")
    h = n // 2 + 1
    s = 1.0 if scale is None else float(scale)
    red = np.mod(
        np.outer(np.arange(h, dtype=np.int64), np.arange(n, dtype=np.int64)), n
    ).astype(np.float64)
    ang = (2.0 * np.pi / n) * red
    c = np.full((h, 1), 2.0 * s)
    c[0] = s
    c[-1] = s
    cr = (np.cos(ang) * c).astype(np.float32)
    ci = (-np.sin(ang) * c).astype(np.float32)
    return {"n": n, "h": h, "cr": cr, "ci": ci}


@functools.lru_cache(maxsize=None)
def get_rfft_direct_packed_plan(n: int, scale: float | None = None) -> dict:
    """ONE-dot direct real forward (no dispatch gate routes to it yet):
    pack the one-sided cos table and the INTERIOR
    sin columns into a single (n, n) table

        T = [ C (n, h) | S[:, 1:h-1] (n, h-2) ],   h = n/2 + 1

    so ``out = x @ T`` yields columns [0, h) = Re X[0..h) and columns
    [h, n) = Im X[1..h-1) — the sin columns at k = 0 and n/2 are exactly
    zero and carry no information (real input ⇒ Im X[0] = Im X[n/2] = 0).
    Replaces the 2-dot direct form with ONE (n, n) dot; consumers that
    reduce re² + im²
    (welch/psd/spectrogram) can consume the packed layout without any
    unpack pass.
    """
    if n & (n - 1) or n < 8:
        raise ValueError(f"packed rfft plans require power-of-two n >= 8, got {n}")
    if n > DIRECT_MAX:
        raise ValueError(f"n={n} exceeds DIRECT_MAX={DIRECT_MAX}")
    h = n // 2 + 1
    s = 1.0 if scale is None else float(scale)
    red = np.mod(
        np.outer(np.arange(n, dtype=np.int64), np.arange(h, dtype=np.int64)), n
    ).astype(np.float64)
    ang = (2.0 * np.pi / n) * red
    c = (np.cos(ang) * s).astype(np.float32)  # (n, h)
    sn = (-np.sin(ang) * s).astype(np.float32)
    t = np.concatenate([c, sn[:, 1 : h - 1]], axis=1)  # (n, n)
    return {"n": n, "h": h, "t": t}


@functools.lru_cache(maxsize=None)
def get_irfft_direct_k128_plan(n: int, scale: float | None = None) -> dict:
    """Power-of-two-deep variant of :func:`get_irfft_direct_plan`.

    The direct fold contracts h = n/2 + 1 bins, one more than a power of
    two.  But the Nyquist row needs no dot at all: its sin row is exactly
    zero and its cos row is s*(-1)^m, so

        x = xr[:, :h-1] @ cr' + xi[:, :h-1] @ ci' + xr[:, h-1:] * alt

    with cr'/ci' the first h-1 = n/2 rows (K = n/2) and ``alt`` the
    broadcast row — an elementwise term XLA fuses into the dot epilogue.
    DC-imag handling is unchanged (ci row 0 is exactly zero).  Gated by
    tuning.irfft_direct_k128.
    """
    base = get_irfft_direct_plan(n, scale)
    h = base["h"]
    return {
        "n": n,
        "h": h,
        "cr": np.ascontiguousarray(base["cr"][: h - 1]),
        "ci": np.ascontiguousarray(base["ci"][: h - 1]),
        "alt": np.ascontiguousarray(base["cr"][h - 1 : h]),
    }



def describe_plan(n: int, batch: int = 1, real_input: bool = True) -> dict:
    """Explain how a (batch, n) transform will dispatch — introspection for
    users and debugging, mirroring the selection in ``kernels/large.py``.

    Pure arithmetic — no tables are generated or cached (a staged plan's
    table set can run to hundreds of MB at MAX_N).

    >>> describe_plan(256)["path"]
    'direct'
    >>> p = describe_plan(4096); (p["path"], p["layout"], p["split"])
    ('fourstep', 'folded', (64, 64))
    >>> p = describe_plan(65536, batch=1); (p["layout"], p["split"])
    ('half-spectrum', (256, 256))
    >>> p = describe_plan(65536, batch=1, real_input=False); p["layout"]
    'transpose'
    >>> p = describe_plan(1 << 20); (p["path"], p["split"], p["stage_b_split"])
    ('staged', (128, 8192), (64, 128))
    """
    if n < 2 or n & (n - 1):
        raise ValueError(f"describe_plan requires power-of-two n >= 2, got {n}")
    if n > MAX_N:
        raise ValueError(f"n={n} exceeds MAX_N={MAX_N}")
    out: dict = {"n": n, "batch": batch, "real_input": real_input}
    if n <= DIRECT_MAX:
        out.update(path="direct", engine="jnp matmul", split=(n, 1), layout=None)
        return out
    half = real_input and half_spectrum_applies(n)
    if n <= FUSED_MAX:
        if half:
            n1, n2 = balanced_split(n)
            out.update(
                path="fourstep",
                engine="jnp einsum graph",
                split=(n1, n2),
                wide=False,
                layout="half-spectrum",
            )
            return out
        wide = wide_split_applies(batch, n)
        n1, n2 = fused_split(n, batch)
        out.update(
            path="fourstep",
            engine="jnp einsum graph",
            split=(n1, n2),
            wide=wide,
            layout="folded" if use_folded_layout(batch, n) else "transpose",
        )
        return out
    n1 = _stage_a_n1(n)
    n2 = n // n1
    out.update(
        path="staged",
        engine="einsum stage-A + folded-einsum stage-B",
        split=(n1, n2),
        layout="half-spectrum" if half and stage_b_plannable(n2) else "folded",
        stage_b_split=(n2 // 128, 128) if stage_b_plannable(n2) else None,
    )
    return out


def stage_b_plannable(n2: int) -> bool:
    """True when stage B runs as the einsum four-step with the digit reversal
    folded into the final dot's output permutation
    (kernels/fused_jnp.py:stage_b_jnp) — needs the m2 = 128 row
    split.  Every production staged plan (n2 >= 1024) qualifies; the guard
    exists for forced-small test configs, which fall back to the recursive
    stage B + XLA transpose."""
    return n2 % 128 == 0 and n2 >= 256

def stage_a_col_tile(n2: int) -> int:
    """Column tile of the factored stage-A twiddle (``get_stage_a_plan``).

    The twiddle is stored as an outer (n1, n2/ct) and an inner (n1, ct)
    factor; ``ct`` is also the granularity at which the staged real-output
    inverse skips mirror columns.  Clamped to n2 for forced-small configs.
    """
    return min(512, n2)


def _stage_a_n1(n: int) -> int:
    n1 = min(get_tuning().stage_a_n1, n // 2)
    # Keep n2 a fused size (n1 grows past 128 only above n = 2^23).
    while n // n1 > FUSED_MAX:
        n1 *= 2
    return n1


@functools.lru_cache(maxsize=None)
def get_stage_a_plan(n: int, sign: int, ct: int | None = None) -> dict[str, Any]:
    """Tables for the staged large-N path (see kernels/large.py).

    ``f1``: the n1 x n1 column-DFT matrix (+ Karatsuba sum/diff variants);
    the stage-A twiddle W_n^(k1 * col) is stored FACTORED over the column
    tile ct: ``two`` (n1, n2/ct) with two[k1, j] = W_n^(k1*j*ct) and
    ``twi`` (n1, ct) with twi[k1, cc] = W_n^(k1*cc) — stage A rebuilds the
    full table with one complex multiply inside its twiddle fusion instead
    of reading an n-sized table (8 MB at 2^20, 134 MB at 2^24).  Both
    factors are f64-generated
    unit-modulus entries, so the reconstructed twiddle is within 2 ulp of
    the direct table.  ``stage_b`` carries the row-transform tables for the
    einsum stage B with the folded digit reversal (m1/m2 ext DFT matrices
    and the n2-twiddle, oriented (m2, m1) = [a2, j1]).
    """
    if n <= FUSED_MAX:
        raise ValueError(f"n={n} fits a fused plan; the staged path is not needed")
    if n > MAX_N:
        raise ValueError(f"n={n} exceeds MAX_N={MAX_N}")
    n1 = _stage_a_n1(n)
    n2 = n // n1
    f1r, f1i, f1s, f1d = dft_matrix_ext(n1, sign)
    if ct is None:
        ct = stage_a_col_tile(n2)
    elif not 1 <= ct <= n2 or n2 % ct:
        raise ValueError(f"ct={ct} must divide n2={n2}")
    # outer[k1, j] = W_n^(k1 * j * ct) = W_(n/ct)^(k1 * j): exact integer
    # angle reduction at the smaller denominator.
    two_r, two_i = twiddle_table(n1, n2 // ct, n // ct, sign)
    twi_r, twi_i = twiddle_table(n1, ct, n, sign)
    plan: dict[str, Any] = {
        "n1": n1,
        "n2": n2,
        "ct": ct,
        "f1r": f1r, "f1i": f1i, "f1s": f1s, "f1d": f1d,
        "two_r": two_r, "two_i": two_i,
        "twi_r": twi_r, "twi_i": twi_i,
        "stage_b": None,
    }
    if stage_b_plannable(n2):
        # m2 = 128: the row four-step's dominant second matmul contracts
        # 128 deep.
        m1, m2 = n2 // 128, 128
        g1r, g1i, g1s, g1d = dft_matrix_ext(m1, sign)
        g2r, g2i, g2s, g2d = dft_matrix_ext(m2, sign)
        btwr, btwi = twiddle_table(m2, m1, n2, sign)
        plan["stage_b"] = {
            "m1": m1, "m2": m2,
            "f1r": g1r, "f1i": g1i, "f1s": g1s, "f1d": g1d,
            "f2r": g2r, "f2i": g2i, "f2s": g2s, "f2d": g2d,
            "twr": btwr, "twi": btwi,
        }
    return plan


def get_stage_b_irfft_plan(n: int, scale: float | None = None) -> dict | None:
    """Per-row Hermitian-fold tables for the staged real-output inverse.

    After the staged inverse's stage A + twiddle, each k1 row of the
    (B, n1, n2) intermediate is ITSELF a Hermitian length-n2 sequence:
    with S[k1, c] = sum_a w_{n1}^{a k1} X[a*n2 + c] and the input Hermitian
    (X[n-i] = conj(X[i])), S[k1, n2-c] = conj(w_{n1}^{k1} S[k1, c]), and
    the stage-A twiddle w_n^{k1(n2-c)} = w_{n1}^{k1} * conj(w_n^{k1 c})
    supplies exactly the cancelling phase, so Z[k1, n2-c] = conj(Z[k1, c])
    with no residual factor (kernels/fused_jnp.py:stage_b_irfft_jnp).

    Stage B for real output is then the fused-size fold applied per row:
    :func:`get_irfft_plan` at length n2 with split (m2, m1) = (128, n2/128)
    — the fold digit aligned with the row layout's MINOR digit, stage-2
    contraction 64 deep.  Returns None when stage B is not plannable
    (forced-small test configs).
    """
    n1 = _stage_a_n1(n)
    n2 = n // n1
    if not stage_b_plannable(n2) or n2 < 16:
        return None
    m1, m2 = n2 // 128, 128
    if m2 * m1 != n2 or m2 & (m2 - 1):
        return None
    return get_irfft_plan(n2, scale=scale, split=(m2, m1))
