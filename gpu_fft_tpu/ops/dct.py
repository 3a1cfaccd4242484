"""Discrete cosine / sine transforms (types I-IV) via the FFT path.

Extension beyond the reference surface.  DCT-II ("the DCT") is computed with
Makhoul's reduction: permute the signal into even-index samples ascending
followed by odd-index samples descending, take ONE same-length FFT through
this library's measured path (any length — non-pow2 runs exactly via
Bluestein), and rotate each bin by e^{-i*pi*k/(2n)}.  DCT-III inverts that
factorization (it is the unnormalized inverse of DCT-II up to 2n).  The DSTs
ride the classic index/sign identities to the DCT cores:

    DST-II(x)[k]  = DCT-II(x~)[n-1-k],   x~[j] = (-1)^j x[j]
    DST-III(y)[k] = (-1)^k DCT-III(y~)[k],  y~[j] = y[n-1-j]

Conventions match ``scipy.fft.dct`` / ``dst`` (types 1-4, ``norm=None``
unnormalized and ``norm='ortho'``), verified element-wise in the test suite.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "dct",
    "idct",
    "dst",
    "idst",
    "dct_device",
    "idct_device",
    "dst_device",
    "idst_device",
    "dctn",
    "idctn",
    "dctn_device",
    "idctn_device",
    "dstn",
    "idstn",
    "dstn_device",
    "idstn_device",
]


@functools.lru_cache(maxsize=None)
def _rotation(n: int) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin of pi*k/(2n), k = 0..n-1, f64-generated f32 tables."""
    ang = np.pi * np.arange(n, dtype=np.float64) / (2.0 * n)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _flat_rev_pow2(a):
    """Flat last-axis reversal of a (B, m) array with pow2 m >= 128, as a
    (rows, 128) two-axis ``lax.rev`` (equal to the flat reversal)."""
    from jax import lax

    b, m = a.shape
    rows = max(m // 128, 1)
    return lax.rev(a.reshape(b, rows, -1), (1, 2)).reshape(b, m)


def _makhoul_permute(x):
    """v = [x[0::2] ‖ reversed(x[1::2])] along the last axis.

    Pow2 n >= 256 runs the stride-2 deinterleave as a 0/1 PERMUTATION
    MATMUL on (.., 256) blocks + aligned slices (block-local evens/odds
    land contiguous) and the odd-half reversal as a 2-D tile rev.  Other
    lengths keep the strided-slice + flip form (still never a gather).
    """
    import jax.numpy as jnp

    b, n = x.shape
    if n >= 256 and n & (n - 1) == 0:
        from jax import lax

        from ..plan import deinterleave_matrix

        xp = jnp.dot(
            x.reshape(b * (n // 256), 256),
            deinterleave_matrix(),
            precision=lax.Precision.HIGHEST,  # exact: P is 0/1
            preferred_element_type=jnp.float32,
        ).reshape(b, n // 256, 256)
        ev = xp[:, :, :128].reshape(b, n // 2)
        od = xp[:, :, 128:].reshape(b, n // 2)
        return jnp.concatenate([ev, _flat_rev_pow2(od)], axis=-1)
    return jnp.concatenate([x[:, 0::2], jnp.flip(x[:, 1::2], axis=-1)], axis=-1)


def _makhoul_unpermute(v):
    """Inverse of :func:`_makhoul_permute`: x[0::2] = v[:h], x[1::2] =
    reversed(v[h:]) — the transpose of the permutation matmul at pow2
    n >= 256 (P is orthogonal, so P^T is its inverse), an interleaving
    stack otherwise.  No gathers on either path."""
    import jax.numpy as jnp

    b, n = v.shape
    h = (n + 1) // 2  # even-index count
    if n >= 256 and n & (n - 1) == 0:
        from jax import lax

        from ..plan import deinterleave_matrix

        ev = v[:, :h].reshape(b, n // 256, 128)
        od = _flat_rev_pow2(v[:, h:]).reshape(b, n // 256, 128)
        blocks = jnp.concatenate([ev, od], axis=-1).reshape(b * (n // 256), 256)
        out = jnp.dot(
            blocks,
            deinterleave_matrix().T,
            precision=lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        return out.reshape(b, n)
    a = v[:, :h]
    rev = jnp.flip(v[:, h:], axis=-1)  # odd positions, ascending (n // 2 of them)
    if n % 2 == 0:
        return jnp.stack([a, rev], axis=-1).reshape(b, n)
    body = jnp.stack([a[:, : h - 1], rev], axis=-1).reshape(b, n - 1)
    return jnp.concatenate([body, a[:, h - 1 :]], axis=-1)


def _dct2_core(x):
    """Unnormalized DCT-II of (B, n) f32 rows: 2*sum x_j cos(pi*k*(2j+1)/2n)."""
    from .exact import fft_exact_device

    n = x.shape[-1]
    v = _makhoul_permute(x)
    vr, vi = fft_exact_device(v)
    c, s = _rotation(n)
    # X_k = 2 * Re(e^{-i*pi*k/2n} V_k)
    return 2.0 * (vr * c + vi * s)


def _dct3_core(y):
    """Unnormalized DCT-III of (B, n) f32 rows: y_0 + 2*sum_{j>=1} y_j cos(pi*j*(2k+1)/2n).

    Inverts the Makhoul factorization: V_k = (e^{i*pi*k/2n}/2)(y_k - i*y_{n-k})
    (with y_n := 0) is Hermitian for real y, so IFFT(V) is real; un-permuting
    and scaling by 2n gives DCT-III.
    """
    import jax.numpy as jnp

    n = y.shape[-1]
    # t_k = y_{n-k} with t_0 = 0: the flat reversal runs as the 2-D tile
    # rev at pow2 n (flip(y[:, 1:]) == flat_rev(y)[:, :n-1]).
    if n >= 128 and n & (n - 1) == 0:
        t = jnp.concatenate(
            [jnp.zeros_like(y[:, :1]), _flat_rev_pow2(y)[:, : n - 1]], axis=-1
        )
    else:
        t = jnp.concatenate(
            [jnp.zeros_like(y[:, :1]), jnp.flip(y[:, 1:], axis=-1)], axis=-1
        )
    c, s = _rotation(n)
    vr = 0.5 * (y * c + t * s)
    vi = 0.5 * (y * s - t * c)
    if n >= 2 and n & (n - 1) == 0:
        # V is Hermitian (real DCT-III output): the real-output inverse
        # dispatch folds the conjugate half at fold sizes and lets XLA DCE
        # the imaginary output elsewhere (kernels/large.py:inverse_real).
        from ..kernels.large import inverse_real

        xr = inverse_real(vr, vi, n, scale=1.0 / n)
    else:
        from .exact import ifft_exact_device

        xr, _ = ifft_exact_device(vr, vi)
    return (2.0 * n) * _makhoul_unpermute(xr)


@functools.lru_cache(maxsize=None)
def _quarter_rotation(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pre/post twiddles of the type-IV reduction, f64-generated f32:
    (cos, sin) of pi*j/(2n) (pre) and of pi*(2k+1)/(4n) (post)."""
    j = np.arange(n, dtype=np.float64)
    pre = np.pi * j / (2.0 * n)
    post = np.pi * (2.0 * j + 1.0) / (4.0 * n)
    return (
        np.cos(pre).astype(np.float32),
        np.sin(pre).astype(np.float32),
        np.cos(post).astype(np.float32),
        np.sin(post).astype(np.float32),
    )


def _type4_spectrum(x):
    """U_k = first n bins of FFT_2n([x_j * e^{-i*pi*j/(2n)}, 0]) plus the
    post twiddle tables.

    The shared core of DCT-IV and DST-IV: with w = e^{-i*pi/(4n)},
    (2j+1)(2k+1) = 4jk + 2j + 2k + 1 factorizes the quarter-shifted
    cosine/sine into one zero-padded length-2n complex FFT (the 4jk term
    is a HALF-frequency kernel) and two diagonal twiddles.
    """
    import jax.numpy as jnp

    from .exact import fft_exact_device

    n = x.shape[-1]
    pc, ps, tc, ts = _quarter_rotation(n)
    pad = ((0, 0), (0, n))
    ur, ui = fft_exact_device(jnp.pad(x * pc, pad), jnp.pad(-x * ps, pad))
    return ur[:, :n], ui[:, :n], tc, ts


def _dct1_core(x):
    """Unnormalized DCT-I of (B, n>=2) rows: the real part of the FFT of
    the even extension [x_0..x_{n-1}, x_{n-2}..x_1] (length 2n-2)."""
    import jax.numpy as jnp

    from .exact import fft_exact_device

    ext = jnp.concatenate([x, jnp.flip(x[:, 1:-1], axis=-1)], axis=-1)
    yr, _ = fft_exact_device(ext)
    return yr[:, : x.shape[-1]]


def _dst1_core(x):
    """Unnormalized DST-I of (B, n) rows: minus the imaginary part of the
    FFT of the odd extension [0, x, 0, -reversed(x)] (length 2n+2)."""
    import jax.numpy as jnp

    from .exact import fft_exact_device

    b = x.shape[0]
    z = jnp.zeros((b, 1), jnp.float32)
    ext = jnp.concatenate([z, x, z, -jnp.flip(x, axis=-1)], axis=-1)
    _, yi = fft_exact_device(ext)
    return -yi[:, 1 : x.shape[-1] + 1]


def _as_rows(x, name: str):
    import jax.numpy as jnp

    x = jnp.asarray(x, dtype=jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    if x.ndim != 2 or x.shape[-1] < 1:
        raise ValueError(f"{name} expects non-empty 1-D or (B, n) input, got shape {x.shape}")
    return x, squeeze


def _check_type_norm(type: int, norm, name: str) -> None:
    if type not in (1, 2, 3, 4):
        raise ValueError(f"{name} supports types 1-4, got {type}")
    if norm not in (None, "ortho"):
        raise ValueError(f"norm must be None or 'ortho', got {norm!r}")


def dct_device(x, type: int = 2, norm: str | None = None):
    """DCT of real rows (device, jit-composable; ``scipy.fft.dct`` types 1-4).

    ``x``: (n,) or (B, n) f32, any length.  ``norm=None`` is the unnormalized
    convention; ``norm='ortho'`` makes the transform orthonormal (so type 3
    is exactly the inverse of type 2).
    """
    _check_type_norm(type, norm, "dct")
    x, squeeze = _as_rows(x, "dct")
    n = x.shape[-1]
    if type == 1:
        if n < 2:
            raise ValueError("dct type 1 requires n >= 2")
        if norm == "ortho":
            # Orthonormal DCT-I: Mo = diag(c_k) Mr diag(c_j / e_j) sqrt(2/(n-1))
            # with c = 1/sqrt(2) at the endpoints (else 1) and e = the raw
            # kernel's endpoint weight (1 at the ends, 2 interior).
            r2 = np.float32(1.0 / np.sqrt(2.0))
            gin = np.full(n, 0.5 * np.sqrt(2.0 / (n - 1.0)), dtype=np.float32)
            gin[0] = gin[-1] = np.float32(r2 * np.sqrt(2.0 / (n - 1.0)))
            gout = np.ones(n, dtype=np.float32)
            gout[0] = gout[-1] = r2
            y = _dct1_core(x * gin) * gout
        else:
            y = _dct1_core(x)
        return (y[0] if squeeze else y)
    if type == 4:
        ur, ui, tc, ts = _type4_spectrum(x)
        y = 2.0 * (ur * tc + ui * ts)
        if norm == "ortho":
            y = y * np.float32(np.sqrt(1.0 / (2.0 * n)))
        return (y[0] if squeeze else y)
    if type == 2:
        y = _dct2_core(x)
        if norm == "ortho":
            f = np.full(n, np.sqrt(1.0 / (2.0 * n)), dtype=np.float32)
            f[0] = np.sqrt(1.0 / (4.0 * n))
            y = y * f
    else:
        if norm == "ortho":
            f = np.full(n, np.sqrt(1.0 / (2.0 * n)), dtype=np.float32)
            f[0] = np.sqrt(1.0 / n)
            x = x * f
        y = _dct3_core(x)
    return y[0] if squeeze else y


def idct_device(y, type: int = 2, norm: str | None = None):
    """Inverse DCT (device): ``idct(dct(x, type, norm), type, norm) == x``."""
    _check_type_norm(type, norm, "idct")
    inv_type = type if type in (1, 4) else 5 - type  # I/IV self-inverse, 2 <-> 3
    out = dct_device(y, type=inv_type, norm=norm)
    if norm is None:
        import jax.numpy as jnp

        n = out.shape[-1]
        denom = 2.0 * (n - 1.0) if type == 1 else 2.0 * n
        out = out * jnp.float32(1.0 / denom)
    return out


def dst_device(x, type: int = 2, norm: str | None = None):
    """DST of real rows (device; ``scipy.fft.dst`` types 1-4)."""
    import jax.numpy as jnp

    _check_type_norm(type, norm, "dst")
    x, squeeze = _as_rows(x, "dst")
    n = x.shape[-1]
    if type == 1:
        y = _dst1_core(x)
        if norm == "ortho":
            y = y * np.float32(np.sqrt(1.0 / (2.0 * (n + 1.0))))
        return (y[0] if squeeze else y)
    if type == 4:
        ur, ui, tc, ts = _type4_spectrum(x)
        y = 2.0 * (ur * ts - ui * tc)
        if norm == "ortho":
            y = y * np.float32(np.sqrt(1.0 / (2.0 * n)))
        return (y[0] if squeeze else y)
    alt = np.resize(np.array([1.0, -1.0], dtype=np.float32), n)
    if type == 2:
        y = jnp.flip(_dct2_core(x * alt), axis=-1)
        if norm == "ortho":
            f = np.full(n, np.sqrt(1.0 / (2.0 * n)), dtype=np.float32)
            f[-1] = np.sqrt(1.0 / (4.0 * n))
            y = y * f
    else:
        if norm == "ortho":
            f = np.full(n, np.sqrt(1.0 / (2.0 * n)), dtype=np.float32)
            f[-1] = np.sqrt(1.0 / n)
            x = x * f
        y = _dct3_core(jnp.flip(x, axis=-1)) * alt
    return y[0] if squeeze else y


def idst_device(y, type: int = 2, norm: str | None = None):
    """Inverse DST (device): ``idst(dst(x, type, norm), type, norm) == x``."""
    _check_type_norm(type, norm, "idst")
    inv_type = type if type in (1, 4) else 5 - type
    out = dst_device(y, type=inv_type, norm=norm)
    if norm is None:
        import jax.numpy as jnp

        n = out.shape[-1]
        denom = 2.0 * (n + 1.0) if type == 1 else 2.0 * n
        out = out * jnp.float32(1.0 / denom)
    return out


def dct(x, type: int = 2, norm: str | None = None):
    """Host-convenience DCT; see :func:`dct_device`.  NumPy in/out."""
    return np.asarray(dct_device(np.asarray(x, dtype=np.float32), type, norm))


def idct(y, type: int = 2, norm: str | None = None):
    """Host-convenience inverse DCT; see :func:`idct_device`."""
    return np.asarray(idct_device(np.asarray(y, dtype=np.float32), type, norm))


def dst(x, type: int = 2, norm: str | None = None):
    """Host-convenience DST; see :func:`dst_device`."""
    return np.asarray(dst_device(np.asarray(x, dtype=np.float32), type, norm))


def idst(y, type: int = 2, norm: str | None = None):
    """Host-convenience inverse DST; see :func:`idst_device`."""
    return np.asarray(idst_device(np.asarray(y, dtype=np.float32), type, norm))


def _dct_along_axes(x, axes, fn):
    """Apply a (B, n)-rows transform along each of ``axes`` of an N-D array."""
    import jax.numpy as jnp

    for a in axes:
        n = x.shape[a]
        moved = jnp.moveaxis(x, a, -1)
        lead = moved.shape[:-1]
        b = int(np.prod(lead)) if lead else 1
        rows = fn(moved.reshape(b, n))
        x = jnp.moveaxis(rows.reshape(*lead, n), -1, a)
    return x


def _norm_axes(x, axes, name):
    if axes is None:
        return tuple(range(x.ndim))
    out = []
    for a in axes:
        if not -x.ndim <= a < x.ndim:
            raise ValueError(f"{name}: axis {a} out of range for rank {x.ndim}")
        out.append(a % x.ndim)
    if not out:
        raise ValueError(f"{name}: axes must name at least one axis")
    if len(set(out)) != len(out):
        raise ValueError(f"{name}: repeated axes {tuple(axes)}")
    return tuple(out)


def dctn_device(x, type: int = 2, norm: str | None = None, axes=None):
    """N-dimensional DCT over the given axes (default: all), on device.

    ``scipy.fft.dctn`` semantics: the 1-D DCT of the given ``type``/
    ``norm`` applied separably along each axis (the 2-D type-II 'ortho'
    case is the JPEG transform).  Any axis lengths; jit-composable.
    """
    import jax.numpy as jnp

    _check_type_norm(type, norm, "dctn")
    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim == 0:
        raise ValueError("dctn expects at least one axis")
    axes = _norm_axes(x, axes, "dctn")
    return _dct_along_axes(x, axes, lambda r: dct_device(r, type=type, norm=norm))


def idctn_device(y, type: int = 2, norm: str | None = None, axes=None):
    """Inverse N-D DCT: ``idctn(dctn(x)) == x`` (``scipy.fft.idctn``)."""
    import jax.numpy as jnp

    _check_type_norm(type, norm, "idctn")
    y = jnp.asarray(y, dtype=jnp.float32)
    if y.ndim == 0:
        raise ValueError("idctn expects at least one axis")
    axes = _norm_axes(y, axes, "idctn")
    return _dct_along_axes(y, axes, lambda r: idct_device(r, type=type, norm=norm))


def dctn(x, type: int = 2, norm: str | None = None, axes=None):
    """Host-convenience N-D DCT; see :func:`dctn_device`."""
    return np.asarray(dctn_device(np.asarray(x, dtype=np.float32), type, norm, axes))


def idctn(y, type: int = 2, norm: str | None = None, axes=None):
    """Host-convenience inverse N-D DCT; see :func:`idctn_device`."""
    return np.asarray(idctn_device(np.asarray(y, dtype=np.float32), type, norm, axes))


def dstn_device(x, type: int = 2, norm: str | None = None, axes=None):
    """N-dimensional DST over the given axes (``scipy.fft.dstn`` semantics)."""
    import jax.numpy as jnp

    _check_type_norm(type, norm, "dstn")
    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim == 0:
        raise ValueError("dstn expects at least one axis")
    axes = _norm_axes(x, axes, "dstn")
    return _dct_along_axes(x, axes, lambda r: dst_device(r, type=type, norm=norm))


def idstn_device(y, type: int = 2, norm: str | None = None, axes=None):
    """Inverse N-D DST: ``idstn(dstn(x)) == x`` (``scipy.fft.idstn``)."""
    import jax.numpy as jnp

    _check_type_norm(type, norm, "idstn")
    y = jnp.asarray(y, dtype=jnp.float32)
    if y.ndim == 0:
        raise ValueError("idstn expects at least one axis")
    axes = _norm_axes(y, axes, "idstn")
    return _dct_along_axes(y, axes, lambda r: idst_device(r, type=type, norm=norm))


def dstn(x, type: int = 2, norm: str | None = None, axes=None):
    """Host-convenience N-D DST; see :func:`dstn_device`."""
    return np.asarray(dstn_device(np.asarray(x, dtype=np.float32), type, norm, axes))


def idstn(y, type: int = 2, norm: str | None = None, axes=None):
    """Host-convenience inverse N-D DST; see :func:`idstn_device`."""
    return np.asarray(idstn_device(np.asarray(y, dtype=np.float32), type, norm, axes))
