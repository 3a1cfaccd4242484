"""scipy.fft-compatible namespace: complex arrays in, complex arrays out.

The library's native API uses split-complex ``(re, im)`` f32 pairs — the
layout the device compute paths use.  This module wraps the same measured
dispatches in the exact call signatures of ``scipy.fft`` so existing code
can switch by changing one import::

    import gpu_fft_tpu.compat as fft      # instead of scipy.fft
    X = fft.fft(x)                        # complex64, any length, any axis

or, with no code changes at all, through scipy's backend protocol::

    import scipy.fft
    with scipy.fft.set_backend(gpu_fft_tpu.compat.backend):
        X = scipy.fft.fft(x)              # runs on this library's device path

Semantics follow ``scipy.fft`` (verified element-wise in the test suite):
``n``/``s`` crop or zero-pad, ``axis``/``axes`` select, ``norm`` is one of
``"backward"`` (default), ``"ortho"``, ``"forward"``.  Transforms of ANY
length are exact (pow2 lengths ride the fast measured paths, everything
else the Bluestein exact-length path — never silently padded).  Compute is
single precision: float32 in, complex64/float32 out; ``overwrite_x``,
``workers`` and ``plan`` are accepted and ignored (jit owns scheduling).

No counterpart in the reference (pure extension; its API is the split
tuple one mirrored by the top-level package).
"""

from __future__ import annotations

import numpy as np

from .ops.dsp import (  # re-exported helpers, already scipy-compatible
    fftfreq,
    fftshift,
    ifftshift,
    next_fast_len,
    prev_fast_len,
    rfftfreq,
)
from .ops.fht import fht, fhtoffset, ifht  # already scipy signatures

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
    "fht", "ifht", "fhtoffset",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
    "next_fast_len", "prev_fast_len",
    "backend",
]


def _check_norm(norm) -> str:
    if norm is None:
        return "backward"
    if norm in ("backward", "ortho", "forward"):
        return norm
    raise ValueError(f"invalid norm value {norm!r}; must be 'backward', 'ortho' or 'forward'")


def _fwd_scale(norm: str, n: int) -> float:
    return {"backward": 1.0, "ortho": 1.0 / np.sqrt(n), "forward": 1.0 / n}[norm]


def _inv_scale(norm: str, n: int) -> float:
    # on top of the library's inverse, which already divides by n
    return {"backward": 1.0, "ortho": np.sqrt(n), "forward": float(n)}[norm]


def _split(x):
    """Complex or real array-like -> (f32 real part, f32 imag part or None).

    Host complex arrays are split on the HOST, so the device sees the
    library's split-complex layout directly.
    """
    import jax
    import jax.numpy as jnp

    if not isinstance(x, jax.Array):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            return (
                jnp.asarray(np.ascontiguousarray(x.real), dtype=jnp.float32),
                jnp.asarray(np.ascontiguousarray(x.imag), dtype=jnp.float32),
            )
        return jnp.asarray(x, dtype=jnp.float32), None
    if jnp.iscomplexobj(x):
        return jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32)
    return x.astype(jnp.float32), None


def _combine(yr, yi):
    """Split halves -> complex64 via ``lax.complex``: no complex literal, so
    the eager path never ships a complex constant to the device."""
    import jax.numpy as jnp
    from jax import lax

    return lax.complex(jnp.asarray(yr), jnp.asarray(yi))


def _conj_in(x):
    """Conjugate of an array-like as a device complex64 (host-split safe)."""
    xr, xi = _split(x)
    import jax.numpy as jnp

    return _combine(xr, -xi if xi is not None else jnp.zeros_like(xr))


def _fit(x, n: int | None, axis: int):
    """Crop or zero-pad along ``axis`` to length ``n`` (scipy semantics)."""
    import jax.numpy as jnp

    if n is None:
        return x
    if n < 1:
        raise ValueError(f"invalid number of data points ({n}) specified")
    cur = x.shape[axis]
    if n == cur:
        return x
    if n < cur:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, n)
        return x[tuple(idx)]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - cur)
    return jnp.pad(x, pad)


def _to_rows(x, axis: int):
    """Move ``axis`` last and flatten to (B, n); returns (rows, restore)."""
    import jax.numpy as jnp

    x = jnp.moveaxis(x, axis, -1)
    lead = x.shape[:-1]
    rows = x.reshape((-1, x.shape[-1])) if x.ndim != 2 else x

    def restore(y):
        y = y.reshape(lead + (y.shape[-1],))
        return jnp.moveaxis(y, -1, axis)

    return rows, restore


def _norm_axis(axis: int, ndim: int) -> int:
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} is out of bounds for array of dimension {ndim}")
    return axis % ndim


# ── 1-D complex transforms ───────────────────────────────────────────────────


def fft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """Exact n-point DFT along ``axis`` — ``scipy.fft.fft`` semantics, complex64."""
    import jax.numpy as jnp

    from .ops.exact import fft_exact_device

    norm = _check_norm(norm)
    xr, xi = _split(x)
    axis = _norm_axis(axis, xr.ndim) if xr.ndim else 0
    if xr.ndim == 0:
        raise ValueError("fft expects at least a 1-D signal")
    xr = _fit(xr, n, axis)
    xi = _fit(xi, n, axis) if xi is not None else None
    m = xr.shape[axis]
    rows, restore = _to_rows(xr, axis)
    irows = _to_rows(xi, axis)[0] if xi is not None else None
    yr, yi = fft_exact_device(rows, irows)
    out = restore(_combine(yr, yi))
    s = _fwd_scale(norm, m)
    return out * s if s != 1.0 else out


def ifft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """Exact n-point inverse DFT along ``axis`` — ``scipy.fft.ifft`` semantics."""
    import jax.numpy as jnp

    from .ops.exact import ifft_exact_device

    norm = _check_norm(norm)
    xr, xi = _split(x)
    if xr.ndim == 0:
        raise ValueError("ifft expects at least a 1-D signal")
    axis = _norm_axis(axis, xr.ndim)
    if xi is None:
        xi = jnp.zeros_like(xr)
    xr = _fit(xr, n, axis)
    xi = _fit(xi, n, axis)
    m = xr.shape[axis]
    rows, restore = _to_rows(xr, axis)
    irows = _to_rows(xi, axis)[0]
    yr, yi = ifft_exact_device(rows, irows)
    out = restore(_combine(yr, yi))
    s = _inv_scale(norm, m)
    return out * s if s != 1.0 else out


# ── 1-D real / Hermitian transforms ──────────────────────────────────────────


def rfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """One-sided DFT of a real signal — ``scipy.fft.rfft`` semantics."""
    import jax.numpy as jnp

    from .ops.exact import fft_exact_device
    from .ops.transform import rfft_device

    norm = _check_norm(norm)
    xr, xi = _split(x)
    if xi is not None:
        raise TypeError("rfft requires a real input; use fft for complex data")
    if xr.ndim == 0:
        raise ValueError("rfft expects at least a 1-D signal")
    axis = _norm_axis(axis, xr.ndim)
    xr = _fit(xr, n, axis)
    m = xr.shape[axis]
    h = m // 2 + 1
    rows, restore = _to_rows(xr, axis)
    if m >= 2 and m & (m - 1) == 0:
        yr, yi = rfft_device(rows)  # measured half-spectrum path
    else:
        yr, yi = fft_exact_device(rows)
        yr, yi = yr[..., :h], yi[..., :h]
    out = restore(_combine(yr, yi))
    s = _fwd_scale(norm, m)
    return out * s if s != 1.0 else out


def irfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """Real inverse of :func:`rfft` — ``scipy.fft.irfft`` semantics.

    ``n`` is the OUTPUT length (default ``2*(m - 1)``); the one-sided input
    is cropped or zero-padded to ``n//2 + 1`` bins first, like scipy.
    """
    import jax.numpy as jnp

    from .ops.exact import ifft_exact_device
    from .ops.transform import irfft_device

    norm = _check_norm(norm)
    xr, xi = _split(x)
    if xr.ndim == 0:
        raise ValueError("irfft expects at least a 1-D spectrum")
    axis = _norm_axis(axis, xr.ndim)
    if xi is None:
        xi = jnp.zeros_like(xr)
    if n is None:
        n = 2 * (xr.shape[axis] - 1)
        if n < 1:
            raise ValueError("invalid number of data points (0) specified")
    h = n // 2 + 1
    xr = _fit(xr, h, axis)
    xi = _fit(xi, h, axis)
    rr, restore = _to_rows(xr, axis)
    ri = _to_rows(xi, axis)[0]
    if n >= 16 and n & (n - 1) == 0:
        out = restore(irfft_device(rr, ri))  # measured real-output fold path
    else:
        # Hermitian extension: full[k] = conj(full[n-k]) for the upper half.
        tail = slice(1, n - h + 1)
        fr = jnp.concatenate([rr, jnp.flip(rr[..., tail], axis=-1)], axis=-1)
        fi = jnp.concatenate([ri, -jnp.flip(ri[..., tail], axis=-1)], axis=-1)
        fi = fi.at[..., 0].set(0.0)
        if n % 2 == 0:
            fi = fi.at[..., h - 1].set(0.0)
        yr, _ = ifft_exact_device(fr, fi)
        out = restore(yr)
    s = _inv_scale(norm, n)
    return out * s if s != 1.0 else out


def hfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """Real spectrum of a Hermitian signal — ``scipy.fft.hfft`` semantics:
    ``hfft(a, n) = irfft(conj(a), n) * n`` with the forward norm rules."""
    import jax.numpy as jnp

    norm = _check_norm(norm)
    if n is None:
        n = 2 * (np.shape(x)[_norm_axis(axis, max(np.ndim(x), 1))] - 1)
        if n < 1:
            raise ValueError("invalid number of data points (0) specified")
    out = irfft(_conj_in(x), n, axis=axis, norm=None)
    return out * np.float32(n * _fwd_scale(norm, n))


def ihfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """Inverse of :func:`hfft` — ``ihfft(x, n) = conj(rfft(x, n)) / n`` with
    the inverse norm rules (``scipy.fft.ihfft`` semantics)."""
    import jax.numpy as jnp

    norm = _check_norm(norm)
    out = jnp.conj(rfft(x, n, axis=axis, norm=None))
    m = n if n is not None else np.shape(x)[_norm_axis(axis, max(np.ndim(x), 1))]
    return out * np.float32(_inv_scale(norm, m) / m)


# ── N-D transforms (separable: repeated 1-D over the named axes) ─────────────


def _resolve_axes(x_ndim: int, s, axes):
    """scipy's s/axes resolution: axes default to all (or the last len(s))."""
    if axes is None:
        axes = list(range(x_ndim)) if s is None else list(range(x_ndim - len(s), x_ndim))
    else:
        axes = [a % x_ndim if -x_ndim <= a < x_ndim else None for a in np.atleast_1d(axes)]
        if None in axes:
            raise ValueError("axes exceeds dimensionality of input")
        axes = [int(a) for a in axes]
    if len(set(axes)) != len(axes):
        raise ValueError("all axes must be unique")
    if s is not None and len(s) != len(axes):
        raise ValueError("when given, axes and shapes arguments have to be of the same length")
    return axes, (list(s) if s is not None else [None] * len(axes))


def fftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """N-D DFT over ``axes`` — ``scipy.fft.fftn`` semantics (also covers fft2)."""
    axes, sizes = _resolve_axes(np.ndim(x), s, axes)
    out = x
    for a, m in zip(axes, sizes):
        out = fft(out, m, axis=a, norm=norm)
    return out


def ifftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """N-D inverse DFT over ``axes`` — ``scipy.fft.ifftn`` semantics."""
    axes, sizes = _resolve_axes(np.ndim(x), s, axes)
    out = x
    for a, m in zip(axes, sizes):
        out = ifft(out, m, axis=a, norm=norm)
    return out


def fft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None):
    """2-D DFT — ``scipy.fft.fft2`` semantics."""
    return fftn(x, s, axes, norm)


def ifft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None):
    """2-D inverse DFT — ``scipy.fft.ifft2`` semantics."""
    return ifftn(x, s, axes, norm)


def rfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """N-D one-sided DFT of real input: real transform on the LAST named
    axis, complex on the rest — ``scipy.fft.rfftn`` semantics."""
    axes, sizes = _resolve_axes(np.ndim(x), s, axes)
    out = rfft(x, sizes[-1], axis=axes[-1], norm=norm)
    for a, m in zip(axes[:-1], sizes[:-1]):
        out = fft(out, m, axis=a, norm=norm)
    return out


def irfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """Inverse of :func:`rfftn` — ``scipy.fft.irfftn`` semantics (the last
    named axis carries the one-sided real inverse)."""
    axes, sizes = _resolve_axes(np.ndim(x), s, axes)
    out = x
    for a, m in zip(axes[:-1], sizes[:-1]):
        out = ifft(out, m, axis=a, norm=norm)
    return irfft(out, sizes[-1], axis=axes[-1], norm=norm)


def rfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None):
    """2-D one-sided DFT of real input — ``scipy.fft.rfft2`` semantics."""
    return rfftn(x, s, axes, norm)


def irfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None):
    """2-D inverse of :func:`rfft2` — ``scipy.fft.irfft2`` semantics."""
    return irfftn(x, s, axes, norm)


def _swap_norm(norm):
    # A Hermitian transform IS the opposite-direction real transform of the
    # conjugate, with the norm's direction swapped (verified exact vs scipy):
    # hfftn(x, norm) = irfftn(conj(x), swap(norm)).
    return {None: "forward", "backward": "forward", "forward": "backward", "ortho": "ortho"}[norm]


def hfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """N-D spectrum of a Hermitian-symmetric signal — ``scipy.fft.hfftn``."""
    _check_norm(norm)
    return irfftn(_conj_in(x), s, axes, _swap_norm(norm))


def ihfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None):
    """Inverse of :func:`hfftn` — ``scipy.fft.ihfftn`` semantics."""
    import jax.numpy as jnp

    _check_norm(norm)
    return jnp.conj(rfftn(x, s, axes, _swap_norm(norm)))


def hfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None):
    """2-D Hermitian-input spectrum — ``scipy.fft.hfft2`` semantics."""
    return hfftn(x, s, axes, norm)


def ihfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None):
    """2-D inverse of :func:`hfft2` — ``scipy.fft.ihfft2`` semantics."""
    return ihfftn(x, s, axes, norm)


# ── DCT / DST with scipy's n/axis handling around the measured cores ─────────


def _real_1d(op, x, type, n, axis, norm, orthogonalize):
    if orthogonalize not in (None, True) and norm == "ortho":
        raise NotImplementedError("orthogonalize=False is not supported")
    xr, xi = _split(x)
    if xi is not None:
        raise TypeError("DCT/DST require real input")
    if xr.ndim == 0:
        raise ValueError("expects at least a 1-D signal")
    axis = _norm_axis(axis, xr.ndim)
    xr = _fit(xr, n, axis)
    rows, restore = _to_rows(xr, axis)
    return restore(op(rows, type=type, norm=norm))


def dct(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, orthogonalize=None):
    """DCT types 1-4 — ``scipy.fft.dct`` semantics."""
    from .ops.dct import dct_device

    return _real_1d(dct_device, x, type, n, axis, norm, orthogonalize)


def idct(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, orthogonalize=None):
    """Inverse DCT — ``scipy.fft.idct`` semantics."""
    from .ops.dct import idct_device

    return _real_1d(idct_device, x, type, n, axis, norm, orthogonalize)


def dst(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, orthogonalize=None):
    """DST types 1-4 — ``scipy.fft.dst`` semantics."""
    from .ops.dct import dst_device

    return _real_1d(dst_device, x, type, n, axis, norm, orthogonalize)


def idst(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, orthogonalize=None):
    """Inverse DST — ``scipy.fft.idst`` semantics."""
    from .ops.dct import idst_device

    return _real_1d(idst_device, x, type, n, axis, norm, orthogonalize)


def _real_nd(op1d, x, type, s, axes, norm, orthogonalize):
    axes, sizes = _resolve_axes(np.ndim(x), s, axes)
    out = x
    for a, m in zip(axes, sizes):
        out = op1d(out, type=type, n=m, axis=a, norm=norm, orthogonalize=orthogonalize)
    return out


def dctn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False, workers=None, orthogonalize=None):
    """N-D DCT — ``scipy.fft.dctn`` semantics."""
    return _real_nd(dct, x, type, s, axes, norm, orthogonalize)


def idctn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False, workers=None, orthogonalize=None):
    """N-D inverse DCT — ``scipy.fft.idctn`` semantics."""
    return _real_nd(idct, x, type, s, axes, norm, orthogonalize)


def dstn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False, workers=None, orthogonalize=None):
    """N-D DST — ``scipy.fft.dstn`` semantics."""
    return _real_nd(dst, x, type, s, axes, norm, orthogonalize)


def idstn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False, workers=None, orthogonalize=None):
    """N-D inverse DST — ``scipy.fft.idstn`` semantics."""
    return _real_nd(idst, x, type, s, axes, norm, orthogonalize)


# ── scipy.fft backend protocol (uarray) ──────────────────────────────────────

_UA_IMPLS = {
    name: obj
    for name, obj in list(globals().items())
    if name in __all__ and callable(obj) and name != "backend"
}


class _Backend:
    """uarray backend for ``scipy.fft.set_backend``: dispatches every
    function this module implements to the device path, and returns
    NotImplemented for the rest so scipy falls back to its own."""

    __ua_domain__ = "numpy.scipy.fft"

    @staticmethod
    def __ua_convert__(dispatchables, coerce):
        # accept array-likes as-is; our wrappers coerce to f32/jnp themselves
        return tuple(d.value for d in dispatchables)

    @staticmethod
    def __ua_function__(method, args, kwargs):
        fn = _UA_IMPLS.get(method.__name__)
        if fn is None:
            return NotImplemented
        try:
            return fn(*args, **kwargs)
        except NotImplementedError:
            return NotImplemented


backend = _Backend


# ── scipy.fft worker/backend-control API parity ─────────────────────────────
#
# scipy.fft's remaining module surface is process-level control knobs.  The
# workers pool (scipy's pocketfft thread count) has no meaning here — XLA
# owns scheduling — so the workers API is kept as a faithful context-managed
# no-op (values round-trip; compute is unaffected, exactly like passing
# ``workers=`` to the transforms).  The backend registration trio delegates
# to scipy's own uarray machinery with THIS module's backend as the default
# argument, so ``gpu_fft_tpu.compat.set_global_backend()`` makes plain
# ``scipy.fft.fft`` calls run on the device path.

import contextlib as _contextlib
import threading as _threading

_workers_state = _threading.local()


def get_workers() -> int:
    """``scipy.fft.get_workers``: the current workers-context value (the
    default 1 unless inside :func:`set_workers`).  Informational only —
    XLA owns device scheduling."""
    return getattr(_workers_state, "value", 1)


@_contextlib.contextmanager
def set_workers(workers: int):
    """``scipy.fft.set_workers`` context manager (value round-trips through
    :func:`get_workers`; compute is unaffected — jit owns scheduling)."""
    if int(workers) == 0:
        raise ValueError("workers must not be zero")
    prev = get_workers()
    _workers_state.value = int(workers)
    try:
        yield
    finally:
        _workers_state.value = prev


def set_global_backend(backend_=None, coerce: bool = False, only: bool = False, try_last: bool = False):
    """Install a backend for plain ``scipy.fft`` calls process-wide
    (default: THIS module's backend).  Delegates to scipy's uarray
    registry — after this, ``scipy.fft.fft(x)`` runs on the library paths."""
    import scipy.fft as _sfft

    _sfft.set_global_backend(backend if backend_ is None else backend_, coerce=coerce, only=only, try_last=try_last)


def set_backend(backend_=None, coerce: bool = False, only: bool = False):
    """Context manager routing ``scipy.fft`` calls through a backend
    (default: this module's backend); see ``scipy.fft.set_backend``::

        with gpu_fft_tpu.compat.set_backend():
            X = scipy.fft.fft(x)          # runs on the library paths
    """
    import scipy.fft as _sfft

    return _sfft.set_backend(backend if backend_ is None else backend_, coerce=coerce, only=only)


def register_backend(backend_=None):
    """Register a backend (default: this module's) for scipy.fft fallback
    dispatch; see ``scipy.fft.register_backend``."""
    import scipy.fft as _sfft

    _sfft.register_backend(backend if backend_ is None else backend_)


def skip_backend(backend_=None):
    """Context manager skipping a backend (default: this module's) inside
    ``scipy.fft`` dispatch; see ``scipy.fft.skip_backend``."""
    import scipy.fft as _sfft

    return _sfft.skip_backend(backend if backend_ is None else backend_)


__all__ += [
    "get_workers",
    "set_workers",
    "set_backend",
    "set_global_backend",
    "register_backend",
    "skip_backend",
]
