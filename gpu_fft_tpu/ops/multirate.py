"""Polyphase-style multirate ops: upfirdn, resample_poly, decimate.

Extension beyond the reference surface.  The classic multirate primitives,
built on the overlap-add convolution engine (``ops/filter.py``) with every
rate change expressed as static vector ops: zero-stuffing is an
interleaving ``stack(...).reshape`` and downsampling is a static strided
slice — never a gather/scatter (``docs/ALGORITHM.md`` §4d).  Where scipy
implements these with a streaming polyphase C kernel, this realization
runs the full upsampled convolution through the batched block transform:
the matmul throughput dwarfs the polyphase arithmetic savings, and the
shapes stay static for jit.
"""

from __future__ import annotations

from math import gcd as _gcd

import numpy as np

__all__ = [
    "upfirdn",
    "upfirdn_device",
    "resample_poly",
    "resample_poly_device",
    "decimate",
]


def upfirdn_device(h, x, up: int = 1, down: int = 1):
    """Upsample -> FIR filter -> downsample (``scipy.signal.upfirdn``).

    ``x``: (n,) or (B, n) real f32 rows; ``h``: (lh,) taps.  Inserts
    ``up - 1`` zeros between samples (interleave reshape, no scatter),
    convolves through the overlap-add block engine, keeps every
    ``down``-th sample (static strided slice).  Output length
    ``((n-1)*up + lh - 1)//down + 1`` per row; jit-composable.
    """
    import jax.numpy as jnp

    from .filter import oaconvolve_device

    x = jnp.asarray(x, dtype=jnp.float32)
    h = jnp.asarray(h, dtype=jnp.float32)
    if h.ndim != 1 or h.shape[0] == 0:
        raise ValueError("upfirdn expects non-empty 1-D taps")
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    if x.ndim != 2 or x.shape[-1] == 0:
        raise ValueError(f"upfirdn expects non-empty 1-D or (B, n) input, got {x.shape}")
    b, n = x.shape
    if up > 1:
        stuffed = jnp.concatenate(
            [x[:, :, None], jnp.zeros((b, n, up - 1), jnp.float32)], axis=2
        ).reshape(b, n * up)[:, : (n - 1) * up + 1]
    else:
        stuffed = x
    full = oaconvolve_device(stuffed, h)  # (b, (n-1)*up + lh)
    out = full[:, ::down] if down > 1 else full
    return out[0] if squeeze else out


def upfirdn(h, x, up: int = 1, down: int = 1):
    """Host-convenience :func:`upfirdn_device`; NumPy in/out.

    >>> upfirdn([1.0, 1.0, 1.0], [1.0, 2.0, 3.0], up=2).round(5).tolist()
    [1.0, 1.0, 3.0, 2.0, 5.0, 3.0, 3.0]
    """
    return np.asarray(upfirdn_device(h, np.asarray(x, dtype=np.float32), up, down))


def _poly_filter(up: int, down: int, window) -> np.ndarray:
    """The resample_poly anti-alias FIR: kaiser-5.0 by default, cutoff at
    the tighter of the two Nyquists, unity passband after upsampling."""
    from .filter import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate  # scipy's length heuristic
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=window)
    return h * up


def resample_poly_device(x, up: int, down: int, window=("kaiser", 5.0)):
    """Polyphase-style rational-rate resampling (``scipy.signal.resample_poly``
    semantics for real input, 'constant' zero padding).

    ``x``: (n,) or (B, n) real f32.  Output length ``ceil(n * up / down)``
    per row.  The anti-alias FIR is the same kaiser-windowed design scipy
    uses — or pass ``window`` as an ARRAY of FIR taps to use directly
    (scipy's array-window convention; like scipy, taps are scaled by
    ``up`` to preserve amplitude after zero-stuffing).
    The compensation delay is absorbed by zero-padding the taps to a
    multiple of ``down`` so the kept samples stay phase-aligned.
    """
    import jax.numpy as jnp

    x = jnp.asarray(x, dtype=jnp.float32)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    squeeze = x.ndim == 1
    xs = x[None] if squeeze else x
    if xs.ndim != 2 or xs.shape[-1] == 0:
        raise ValueError(f"resample_poly expects non-empty 1-D or (B, n) input, got {x.shape}")
    g = _gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    n = xs.shape[-1]
    n_out = n * up // down + bool(n * up % down)

    if isinstance(window, np.ndarray) or (
        not isinstance(window, (str, tuple)) and hasattr(window, "__len__")
    ):
        h = np.asarray(window, dtype=np.float64) * up  # scipy scales taps too
        if h.ndim != 1 or h.size == 0:
            raise ValueError("array window must be non-empty 1-D FIR taps")
    else:
        h = _poly_filter(up, down, window)
    half_len = (h.shape[0] - 1) // 2
    # Prepend zeros so the group delay lands on a kept (every down-th)
    # sample; then the first kept sample past the delay is output 0.
    z = (-half_len) % down
    hp = np.concatenate([np.zeros(z), h]).astype(np.float32)
    skip = (half_len + z) // down
    out = upfirdn_device(hp, xs, up, down)[:, skip : skip + n_out]
    if out.shape[-1] < n_out:  # tail ran past the conv: pad (scipy keeps len)
        out = jnp.pad(out, ((0, 0), (0, n_out - out.shape[-1])))
    return out[0] if squeeze else out


def resample_poly(x, up: int, down: int, window=("kaiser", 5.0)):
    """Host-convenience :func:`resample_poly_device`; NumPy in/out."""
    return np.asarray(
        resample_poly_device(np.asarray(x, dtype=np.float32), up, down, window)
    )


def decimate(x, q: int, n: int | None = None, ftype: str = "iir", zero_phase: bool = True):
    """Downsample by ``q`` after an anti-alias filter
    (``scipy.signal.decimate`` semantics, including its defaults).

    ``ftype='iir'`` (scipy's default): order-``n`` (default 8) Chebyshev-I
    lowpass at 0.8/q, applied zero-phase via :func:`~gpu_fft_tpu.filtfilt`
    (or causally via :func:`~gpu_fft_tpu.lfilter`) through the block-state
    engine, then strided slicing.  ``ftype='fir'``: ``n``-order (default
    ``20*q``) hamming ``firwin`` taps; ``zero_phase`` compensates group
    delay through the polyphase path.
    """
    xv = np.asarray(x, dtype=np.float32)
    if xv.ndim != 1 or xv.size == 0:
        raise ValueError("decimate expects a non-empty 1-D signal")
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    if ftype not in ("iir", "fir"):
        raise ValueError(f"ftype must be 'iir' or 'fir', got {ftype!r}")
    if q == 1:
        return xv.copy()
    if ftype == "iir":
        from .design import cheby1
        from .iir import sosfilt, sosfiltfilt

        order = 8 if n is None else int(n)
        if order < 1:
            raise ValueError(f"filter order must be >= 1, got {order}")
        # Second-order sections, not ba: the narrow high-order Chebyshev's
        # ba polynomials are ill-conditioned in f32 (measured 2.4e-2 error
        # at q=7 as ba vs 1.9e-6 as sos through the same engine).
        sos = cheby1(order, 0.05, 0.8 / q, output="sos")
        y = sosfiltfilt(sos, xv) if zero_phase else sosfilt(sos, xv)
        return np.asarray(y[::q], dtype=np.float32)
    from .filter import firwin

    order = 20 * q if n is None else int(n)
    if order < 1:
        raise ValueError(f"filter order must be >= 1, got {order}")
    h = firwin(order + 1, 1.0 / q)
    if zero_phase:
        return resample_poly(xv, 1, q, window=h)
    n_out = xv.shape[0] // q + bool(xv.shape[0] % q)
    return np.asarray(upfirdn(h.astype(np.float32), xv, 1, q))[:n_out].copy()
