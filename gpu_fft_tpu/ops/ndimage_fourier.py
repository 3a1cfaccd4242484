"""Fourier-domain filters — the ``scipy.ndimage`` fourier_* family.

The four filters multiply an already-transformed spectrum by a closed-form
transfer function (the reference library has no counterpart; this extends
the scipy-ecosystem surface the same way ``compat``/``signal`` do):

* ``fourier_gaussian`` — separable ``prod_i exp(-(2*pi*sigma_i*f_i)^2 / 2)``
* ``fourier_uniform``  — separable ``prod_i sinc(size_i * f_i)``
* ``fourier_ellipsoid`` — radial: 1-D ``sinc(r/pi)``, 2-D ``2*J1(r)/r``,
  3-D ``3*(sin r - r*cos r)/r^3`` with ``r = sqrt(sum (pi*size_i*f_i)^2)``
  (conventions pinned numerically against scipy.ndimage; >3-D raises
  NotImplementedError like scipy)
* ``fourier_shift``    — separable ``prod_i exp(-2j*pi*f_i*shift_i)``

Design: the transfer tables are generated host-side in f64 (like
every table in this library — ``kernels/tables.py``) and applied on device
as split-complex f32 multiplies that XLA fuses into one HBM pass; the
separable filters stay 1-D per axis (broadcast multiply — never a
materialized N-D grid), so the device work is O(elements) with O(sum of
axis lengths) table bytes.  J1 is computed to f64 machine precision from
Bessel's integral ``J1(x) = (1/pi) * int_0^pi cos(t - x*sin t) dt`` by the
trapezoid rule, whose error for this integrand decays spectrally once the
point count exceeds ~|x| — no scipy.special dependency (same policy as the
self-contained elliptic kernel in ops/design_ellip).

The real-transform mode (``n >= 0``) follows scipy: the ``axis`` grid is
``j / n`` for ``j < input.shape[axis]`` (an rfft layout of a length-``n``
real signal).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "fourier_gaussian",
    "fourier_uniform",
    "fourier_ellipsoid",
    "fourier_shift",
    "fourier_gaussian_device",
    "fourier_uniform_device",
    "fourier_ellipsoid_device",
    "fourier_shift_device",
]


def _normalize_sequence(val, ndim: int, name: str) -> list[float]:
    if np.isscalar(val):
        return [float(val)] * ndim
    seq = [float(v) for v in np.asarray(val).ravel()]
    if len(seq) != ndim:
        raise ValueError(f"{name} must be a scalar or have one value per axis")
    return seq


def _axis_freqs(shape: tuple[int, ...], n: int, axis: int) -> list[np.ndarray]:
    """Per-axis frequency grids (f64).  ``axis`` uses the real-transform
    layout ``j/n`` when ``n >= 0``; every other axis is fftfreq."""
    ndim = len(shape)
    axis = axis % ndim
    freqs = []
    for ax, m in enumerate(shape):
        if ax == axis and n >= 0:
            if n == 0:
                raise ValueError("n must be positive for a real transform axis")
            freqs.append(np.arange(m, dtype=np.float64) / float(n))
        else:
            freqs.append(np.fft.fftfreq(m).astype(np.float64))
    return freqs


def _bessel_j1(x: np.ndarray) -> np.ndarray:
    """J1 to f64 machine precision via the trapezoid rule on Bessel's
    integral (spectral convergence for point count > ~max|x|)."""
    x = np.asarray(x, np.float64)
    m = int(max(64, 2 * np.ceil(np.abs(x).max() if x.size else 0) + 32))
    t = (np.arange(m, dtype=np.float64) + 0.5) * (np.pi / m)  # midpoint rule
    return np.cos(t[None, :] - x.reshape(-1, 1) * np.sin(t)[None, :]).mean(axis=1).reshape(
        x.shape
    )


def _separable_tables(kind: str, params, shape, n, axis):
    """Per-axis REAL f64 transfer tables for gaussian/uniform."""
    vals = _normalize_sequence(params, len(shape), kind)
    tables = []
    for f, v in zip(_axis_freqs(shape, n, axis), vals):
        if kind == "sigma":
            tables.append(np.exp(-0.5 * (2.0 * np.pi * v * f) ** 2))
        else:  # box size
            tables.append(np.sinc(v * f))
    return tables


def _ellipsoid_table(size, shape, n, axis) -> np.ndarray:
    """Full radial transfer grid (f64).  Non-separable for ndim >= 2, so the
    grid is materialized host-side — the device still sees one fused
    multiply."""
    ndim = len(shape)
    if ndim > 3:
        raise NotImplementedError(
            "fourier_ellipsoid supports up to 3 dimensions (scipy parity)"
        )
    sizes = _normalize_sequence(size, ndim, "size")
    freqs = _axis_freqs(shape, n, axis)
    if ndim == 1:
        return np.sinc(sizes[0] * freqs[0])
    r2 = np.zeros(shape, np.float64)
    for ax, (f, v) in enumerate(zip(freqs, sizes)):
        view = [None] * ndim
        view[ax] = slice(None)
        r2 = r2 + (np.pi * v * f)[tuple(view)] ** 2
    r = np.sqrt(r2)
    with np.errstate(invalid="ignore", divide="ignore"):
        if ndim == 2:
            out = 2.0 * _bessel_j1(r) / r
        else:
            out = 3.0 * (np.sin(r) - r * np.cos(r)) / (r**3)
    return np.where(r == 0.0, 1.0, out)


def _shift_tables(shift, shape, n, axis):
    """Per-axis COMPLEX tables exp(-2j*pi*f*shift) as (re, im) f64 pairs."""
    shifts = _normalize_sequence(shift, len(shape), "shift")
    tables = []
    for f, s in zip(_axis_freqs(shape, n, axis), shifts):
        ang = -2.0 * np.pi * f * s
        tables.append((np.cos(ang), np.sin(ang)))
    return tables


def _bcast(t: np.ndarray, ax: int, ndim: int):
    view = [None] * ndim
    view[ax] = slice(None)
    return t[tuple(view)]


# ── Device (split-complex) variants ──────────────────────────────────────────


def _apply_real_tables(xr, xi, tables):
    import jax.numpy as jnp

    ndim = xr.ndim
    for ax, t in enumerate(tables):
        m = _bcast(jnp.asarray(t, jnp.float32), ax, ndim)
        xr = xr * m
        xi = None if xi is None else xi * m
    return xr, xi


def fourier_gaussian_device(xr, xi, sigma, n: int = -1, axis: int = -1):
    """Split-complex device form of :func:`fourier_gaussian`; ``xi`` may be
    None (real spectrum part).  jit-composable; the per-axis multiplies fuse
    into one pass."""
    return _apply_real_tables(xr, xi, _separable_tables("sigma", sigma, xr.shape, n, axis))


def fourier_uniform_device(xr, xi, size, n: int = -1, axis: int = -1):
    """Split-complex device form of :func:`fourier_uniform`."""
    return _apply_real_tables(xr, xi, _separable_tables("size", size, xr.shape, n, axis))


def fourier_ellipsoid_device(xr, xi, size, n: int = -1, axis: int = -1):
    """Split-complex device form of :func:`fourier_ellipsoid` (ndim <= 3)."""
    import jax.numpy as jnp

    t = jnp.asarray(_ellipsoid_table(size, xr.shape, n, axis), jnp.float32)
    return xr * t, (None if xi is None else xi * t)


def fourier_shift_device(xr, xi, shift, n: int = -1, axis: int = -1):
    """Split-complex device form of :func:`fourier_shift`.  Output is
    genuinely complex, so ``xi=None`` input still returns both parts."""
    import jax.numpy as jnp

    ndim = xr.ndim
    if xi is None:
        xi = jnp.zeros_like(xr)
    for ax, (cr, ci) in enumerate(_shift_tables(shift, xr.shape, n, axis)):
        mr = _bcast(jnp.asarray(cr, jnp.float32), ax, ndim)
        mi = _bcast(jnp.asarray(ci, jnp.float32), ax, ndim)
        xr, xi = xr * mr - xi * mi, xr * mi + xi * mr
    return xr, xi


# ── scipy-signature facade (complex arrays in/out) ───────────────────────────


def _split(input):
    import jax.numpy as jnp

    x = jnp.asarray(input)
    if jnp.iscomplexobj(x):
        return jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32)
    return x.astype(jnp.float32), None


def _check_output(output):
    if output is not None:
        raise ValueError(
            "output= is not supported: JAX arrays are immutable; use the return value"
        )


def _join(yr, yi):
    import jax.numpy as jnp

    return yr if yi is None else yr + 1j * jnp.asarray(yi)


def fourier_gaussian(input, sigma, n: int = -1, axis: int = -1, output=None):
    """Multidimensional Gaussian Fourier filter — ``scipy.ndimage.fourier_gaussian``.

    Multiplies the spectrum by the transform of a Gaussian kernel.  Real
    input stays real (the transfer function is real); compute is f32.
    """
    _check_output(output)
    xr, xi = _split(input)
    return _join(*fourier_gaussian_device(xr, xi, sigma, n, axis))


def fourier_uniform(input, size, n: int = -1, axis: int = -1, output=None):
    """Multidimensional uniform (box) Fourier filter — ``scipy.ndimage.fourier_uniform``."""
    _check_output(output)
    xr, xi = _split(input)
    return _join(*fourier_uniform_device(xr, xi, size, n, axis))


def fourier_ellipsoid(input, size, n: int = -1, axis: int = -1, output=None):
    """Multidimensional ellipsoid Fourier filter — ``scipy.ndimage.fourier_ellipsoid``.

    Supports 1-3 dimensions (scipy parity); the 2-D kernel uses a
    self-contained machine-precision J1 (Bessel-integral trapezoid).
    """
    _check_output(output)
    xr, xi = _split(input)
    return _join(*fourier_ellipsoid_device(xr, xi, size, n, axis))


def fourier_shift(input, shift, n: int = -1, axis: int = -1, output=None):
    """Multidimensional Fourier shift filter — ``scipy.ndimage.fourier_shift``.

    Output is complex regardless of input (phase ramps are complex).
    """
    _check_output(output)
    xr, xi = _split(input)
    return _join(*fourier_shift_device(xr, xi, shift, n, axis))
