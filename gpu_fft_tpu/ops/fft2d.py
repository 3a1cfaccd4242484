"""2-D FFT — an extension beyond the reference's 1-D-only surface.

Built entirely from the measured 1-D machinery (``kernels/large.py``):
row transforms with the batch folded into the leading dim, one transpose,
column transforms, transpose back.  Conventions match ``numpy.fft.fft2``:
split-complex f32 in/out, unnormalized forward, 1/(H*W) on the inverse —
and like numpy, ANY side length works: power-of-two sides take the direct
pow2 path, other lengths run exactly via the Bluestein machinery
(``ops/exact.py``), never by padding.

The reference library has no 2-D transform; this is the natural
extension for image/spectrogram workloads (the row passes batch all H rows
into single matmul sweeps, exactly the launch-amortization the reference's
1-D batch path exists for).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "fft2",
    "ifft2",
    "fft2_device",
    "ifft2_device",
    "fftn_device",
    "ifftn_device",
    "fftn",
    "ifftn",
    "rfft2",
    "irfft2",
    "rfft2_device",
    "irfft2_device",
    "rfftn",
    "irfftn",
    "rfftn_device",
    "irfftn_device",
    "hfft2",
    "ihfft2",
    "hfftn",
    "ihfftn",
    "hfftn_device",
    "ihfftn_device",
]


def _normalize_axes(ndim: int, axes, name: str) -> tuple:
    """Validate and canonicalize an ``axes`` argument (numpy.fft semantics)."""
    if axes is None:
        return tuple(range(ndim))
    norm = []
    for a in axes:
        if not -ndim <= a < ndim:  # numpy.fft raises too
            raise ValueError(f"{name}: axis {a} out of range for rank {ndim}")
        norm.append(a % ndim)
    if not norm:
        raise ValueError(f"{name}: axes must name at least one axis")
    if len(set(norm)) != len(norm):
        raise ValueError(f"{name}: repeated axes {tuple(axes)}")
    return tuple(norm)


def _check_sides(h: int, w: int) -> None:
    from ..config import MAX_N
    from .exact import _check_exact_n

    for name, s in (("height", h), ("width", w)):
        if s < 2:
            raise ValueError(f"fft2 {name} must be >= 2, got {s}")
        if s > MAX_N:
            raise ValueError(f"fft2 {name} {s} exceeds the supported maximum {MAX_N}")
        _check_exact_n(s)  # Bluestein bound for non-pow2 sides


def _rows(xr, xi, n: int, sign: int):
    """Length-n transform of (B, n) rows: pow2 direct, otherwise Bluestein."""
    from ..kernels.large import transform_any
    from .exact import _bluestein

    if n & (n - 1) == 0:
        return transform_any(xr, xi, n, sign)
    return _bluestein(xr, xi, n, sign)


def _transform2d(xr, xi, sign: int):
    """Split-complex 2-D transform over the last two axes of (..., H, W)."""
    import jax.numpy as jnp

    *lead, h, w = xr.shape
    b = int(np.prod(lead)) if lead else 1
    # Rows: all B*H rows in one batched 1-D transform.
    rr, ri = _rows(
        xr.reshape(b * h, w), None if xi is None else xi.reshape(b * h, w), w, sign
    )
    # Columns: axis-0 folded einsums where the gate opens (free trailing
    # axis, zero transpose passes — plan.axis0_applies);
    # otherwise transpose, transform the H-length rows, transpose back.
    from ..kernels.fused_jnp import transform_axis0
    from ..plan import axis0_applies

    if axis0_applies(h, w):
        sr, si = transform_axis0(rr.reshape(b, h, w), ri.reshape(b, h, w), h, sign)
        return sr.reshape(*lead, h, w), si.reshape(*lead, h, w)
    cr = jnp.swapaxes(rr.reshape(b, h, w), 1, 2).reshape(b * w, h)
    ci = jnp.swapaxes(ri.reshape(b, h, w), 1, 2).reshape(b * w, h)
    sr, si = _rows(cr, ci, h, sign)
    out_r = jnp.swapaxes(sr.reshape(b, w, h), 1, 2).reshape(*lead, h, w)
    out_i = jnp.swapaxes(si.reshape(b, w, h), 1, 2).reshape(*lead, h, w)
    return out_r, out_i


def fft2_device(x, imag=None):
    """Forward 2-D FFT of device array(s), staying on device.

    ``x``: (..., H, W) real f32 (or pass ``imag`` for complex input); ANY
    side lengths >= 2 (pow2 sides take the direct path, others run exactly
    via Bluestein).  Returns split-complex (re, im), unnormalized, natural
    order — matching ``numpy.fft.fft2``.
    """
    import jax.numpy as jnp

    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim < 2:
        raise ValueError(f"fft2 expects (..., H, W), got shape {x.shape}")
    _check_sides(x.shape[-2], x.shape[-1])
    xi = None
    if imag is not None:
        xi = jnp.asarray(imag, dtype=jnp.float32)
        if xi.shape != x.shape:
            raise ValueError(f"fft2: real and imag shapes differ: {x.shape} vs {xi.shape}")
    return _transform2d(x, xi, -1)


def ifft2_device(xr, xi):
    """Inverse 2-D FFT (normalized by 1/(H*W)) of split-complex device arrays."""
    import jax.numpy as jnp

    xr = jnp.asarray(xr, dtype=jnp.float32)
    xi = jnp.asarray(xi, dtype=jnp.float32)
    if xr.shape != xi.shape or xr.ndim < 2:
        raise ValueError(
            f"ifft2: real and imag must share one (..., H, W) shape, got {xr.shape} vs {xi.shape}"
        )
    h, w = xr.shape[-2], xr.shape[-1]
    _check_sides(h, w)
    yr, yi = _transform2d(xr, xi, +1)
    s = jnp.float32(1.0 / (h * w))
    return yr * s, yi * s


def fftn_device(x, imag=None, axes=None, sign: int = -1):
    """N-dimensional FFT over the given axes (default: all), on device.

    Generalizes :func:`fft2_device` to any rank — ``numpy.fft.fftn``
    semantics: split-complex f32, unnormalized forward (``sign=-1``) or
    unnormalized inverse (``sign=+1``; callers apply 1/prod(sizes)), any
    axis length >= 2 (non-pow2 via Bluestein).  Each axis is transformed by
    moving it last and batching every other element into rows — one device
    pass per axis.
    """
    import jax.numpy as jnp

    from ..config import MAX_N
    from .exact import _check_exact_n

    xr = jnp.asarray(x, dtype=jnp.float32)
    xi = None if imag is None else jnp.asarray(imag, dtype=jnp.float32)
    if xi is not None and xi.shape != xr.shape:
        raise ValueError(f"fftn: real and imag shapes differ: {xr.shape} vs {xi.shape}")
    if xr.ndim == 0:
        raise ValueError("fftn expects at least one axis")
    axes = _normalize_axes(xr.ndim, axes, "fftn")
    for a in axes:
        s = xr.shape[a]
        if s < 2:
            raise ValueError(f"fftn axis {a} has length {s} < 2")
        if s > MAX_N:
            raise ValueError(f"fftn axis {a} length {s} exceeds the maximum {MAX_N}")
        _check_exact_n(s)
    for a in axes:
        n = xr.shape[a]
        mr = jnp.moveaxis(xr, a, -1)
        mi = None if xi is None else jnp.moveaxis(xi, a, -1)
        lead = mr.shape[:-1]
        b = int(np.prod(lead)) if lead else 1
        rr, ri = _rows(
            mr.reshape(b, n), None if mi is None else mi.reshape(b, n), n, sign
        )
        xr = jnp.moveaxis(rr.reshape(*lead, n), -1, a)
        xi = jnp.moveaxis(ri.reshape(*lead, n), -1, a)
    return xr, xi


def ifftn_device(real, imag, axes=None):
    """N-dimensional inverse FFT on device, normalized by the product of the
    transformed axis lengths (``numpy.fft.ifftn`` semantics).

    Device-side symmetry partner of :func:`fftn_device` (the host
    :func:`ifftn` delegates here): split-complex f32 in and out, the 1/prod
    scale applied on device.
    """
    import jax.numpy as jnp

    xr = jnp.asarray(real, dtype=jnp.float32)
    xi = jnp.asarray(imag, dtype=jnp.float32)
    yr, yi = fftn_device(xr, xi, axes=axes, sign=+1)  # validates axes
    ax = tuple(range(xr.ndim)) if axes is None else tuple(a % xr.ndim for a in axes)
    s = np.float32(1.0 / np.prod([xr.shape[a] for a in ax]))
    return yr * s, yi * s


def fftn(x, axes=None):
    """Host-convenience N-D forward FFT (``numpy.fft.fftn`` semantics)."""
    yr, yi = fftn_device(np.asarray(x, dtype=np.float32), axes=axes)
    return np.asarray(yr), np.asarray(yi)


def ifftn(real, imag, axes=None):
    """Host-convenience N-D inverse FFT, normalized by the product of the
    transformed axis lengths (``numpy.fft.ifftn`` semantics)."""
    yr, yi = ifftn_device(
        np.asarray(real, dtype=np.float32), np.asarray(imag, dtype=np.float32), axes
    )
    return np.asarray(yr), np.asarray(yi)


def fft2(x):
    """Host-convenience forward 2-D FFT: numpy in, (re, im) numpy out."""
    yr, yi = fft2_device(np.asarray(x, dtype=np.float32))
    return np.asarray(yr), np.asarray(yi)


def ifft2(real, imag):
    """Host-convenience inverse 2-D FFT: numpy in, (re, im) numpy out."""
    yr, yi = ifft2_device(
        np.asarray(real, dtype=np.float32), np.asarray(imag, dtype=np.float32)
    )
    return np.asarray(yr), np.asarray(yi)


def rfft2_device(x):
    """One-sided 2-D FFT of real images: the W//2 + 1 unique column bins.

    ``x``: (H, W) or (B, H, W) real f32 with POWER-OF-TWO sides.  Returns
    split-complex (..., H, W//2 + 1) — ``numpy.fft.rfft2`` semantics (rfft
    over the last axis, full FFT over rows).  Half the spectrum, and the
    column pass runs on half the bins; jit-composable.
    """
    import jax.numpy as jnp

    from ..kernels.large import transform_any
    from .transform import rfft_device

    x = jnp.asarray(x, dtype=jnp.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    if x.ndim != 3:
        raise ValueError(f"rfft2 expects (H, W) or (B, H, W), got {x.shape}")
    b, h, w = x.shape
    for name, s in (("height", h), ("width", w)):
        if s < 2 or s & (s - 1):
            raise ValueError(f"rfft2 {name} must be a power of two >= 2, got {s}")
    hw = w // 2 + 1
    rr, ri = rfft_device(x.reshape(b * h, w))  # rows: (b*h, hw)
    from ..plan import axis0_applies

    if axis0_applies(h, hw):
        from ..kernels.fused_jnp import transform_axis0

        out_r, out_i = transform_axis0(rr.reshape(b, h, hw), ri.reshape(b, h, hw), h, -1)
        return (out_r[0], out_i[0]) if squeeze else (out_r, out_i)
    cr = jnp.swapaxes(rr.reshape(b, h, hw), 1, 2).reshape(b * hw, h)
    ci = jnp.swapaxes(ri.reshape(b, h, hw), 1, 2).reshape(b * hw, h)
    sr, si = transform_any(cr, ci, h, -1)  # columns: full complex FFT
    out_r = jnp.swapaxes(sr.reshape(b, hw, h), 1, 2)
    out_i = jnp.swapaxes(si.reshape(b, hw, h), 1, 2)
    return (out_r[0], out_i[0]) if squeeze else (out_r, out_i)


def irfft2_device(xr, xi):
    """Inverse of :func:`rfft2_device`: real images back, 1/(H*W) normalized.

    ``xr, xi``: (..., H, W//2 + 1) split-complex one-sided spectra of
    power-of-two sides.  ``numpy.fft.irfft2`` semantics (even output
    width).
    """
    import jax.numpy as jnp

    from ..kernels.large import transform_any
    from .transform import irfft_device

    xr = jnp.asarray(xr, dtype=jnp.float32)
    xi = jnp.asarray(xi, dtype=jnp.float32)
    if xr.shape != xi.shape:
        raise ValueError(f"irfft2: real and imag shapes differ: {xr.shape} vs {xi.shape}")
    squeeze = xr.ndim == 2
    if squeeze:
        xr, xi = xr[None], xi[None]
    if xr.ndim != 3:
        raise ValueError(f"irfft2 expects (H, hw) or (B, H, hw), got {xr.shape}")
    b, h, hw = xr.shape
    w = 2 * (hw - 1)
    if h < 2 or h & (h - 1) or hw < 2 or w & (w - 1):
        raise ValueError(
            f"irfft2 expects power-of-two sides (H, W//2 + 1 bins), got {xr.shape[1:]}"
        )
    # Columns first: inverse complex FFT over H with the 1/H scale folded
    # into the last matmul table (plan.py).  The axis-0 form makes this
    # leg relayout-free end to end (the following row pass is a plain
    # reshape away).
    from ..plan import axis0_applies

    if axis0_applies(h, hw):
        from ..kernels.fused_jnp import transform_axis0

        rr3, ri3 = transform_axis0(xr, xi, h, +1, scale=1.0 / h)
        rr, ri = rr3.reshape(b * h, hw), ri3.reshape(b * h, hw)
    else:
        cr = jnp.swapaxes(xr, 1, 2).reshape(b * hw, h)
        ci = jnp.swapaxes(xi, 1, 2).reshape(b * hw, h)
        sr, si = transform_any(cr, ci, h, +1, scale=1.0 / h)
        rr = jnp.swapaxes(sr.reshape(b, hw, h), 1, 2).reshape(b * h, hw)
        ri = jnp.swapaxes(si.reshape(b, hw, h), 1, 2).reshape(b * h, hw)
    out = irfft_device(rr, ri).reshape(b, h, w)  # rows carry the 1/W scale
    return out[0] if squeeze else out


def rfft2(x):
    """Host-convenience one-sided 2-D FFT; see :func:`rfft2_device`."""
    yr, yi = rfft2_device(np.asarray(x, dtype=np.float32))
    return np.asarray(yr), np.asarray(yi)


def irfft2(real, imag):
    """Host-convenience inverse of :func:`rfft2`; see :func:`irfft2_device`."""
    return np.asarray(
        irfft2_device(
            np.asarray(real, dtype=np.float32), np.asarray(imag, dtype=np.float32)
        )
    )


def rfftn_device(x, axes=None):
    """One-sided N-D FFT of real input (``numpy.fft.rfftn`` semantics).

    ``x``: real f32 of any rank.  The LAST axis in ``axes`` (default: all
    axes, so the last array axis) carries the real transform and shrinks to
    ``n//2 + 1`` unique bins — riding the measured Hermitian half-spectrum
    dispatch when it is a power of two (non-pow2 lengths run the full exact
    transform and slice); every other named axis gets a full complex FFT of
    any length >= 2 (non-pow2 via Bluestein).  Returns split-complex
    (re, im), unnormalized, on device.
    """
    import jax.numpy as jnp

    from ..config import MAX_N
    from .exact import _check_exact_n
    from .transform import rfft_device

    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim == 0:
        raise ValueError("rfftn expects at least one axis")
    axes = _normalize_axes(x.ndim, axes, "rfftn")
    last = axes[-1]
    w = x.shape[last]
    if w < 2:
        raise ValueError(f"rfftn axis {last} has length {w} < 2")
    if w > MAX_N:
        raise ValueError(f"rfftn axis {last} length {w} exceeds the maximum {MAX_N}")
    _check_exact_n(w)
    hw = w // 2 + 1
    mr = jnp.moveaxis(x, last, -1)
    lead = mr.shape[:-1]
    b = int(np.prod(lead)) if lead else 1
    if w & (w - 1) == 0:
        rr, ri = rfft_device(mr.reshape(b, w))
    else:
        rr, ri = _rows(mr.reshape(b, w), None, w, -1)
        rr, ri = rr[..., :hw], ri[..., :hw]
    xr = jnp.moveaxis(rr.reshape(*lead, hw), -1, last)
    xi = jnp.moveaxis(ri.reshape(*lead, hw), -1, last)
    if axes[:-1]:
        xr, xi = fftn_device(xr, xi, axes=axes[:-1], sign=-1)
    return xr, xi


def irfftn_device(real, imag, axes=None):
    """Inverse of :func:`rfftn_device`: real output back, 1/prod normalized
    (``numpy.fft.irfftn`` semantics, even last-axis output length).

    ``real, imag``: split-complex spectra whose LAST named axis holds
    ``n//2 + 1`` one-sided bins of a POWER-OF-TWO n (the real-output
    Hermitian-fold dispatch handles that axis); the other named axes are
    full two-sided spectra of any length.  Returns the real f32 array with
    the last named axis expanded to ``2 * (bins - 1)``.
    """
    import jax.numpy as jnp

    from .transform import irfft_device

    xr = jnp.asarray(real, dtype=jnp.float32)
    xi = jnp.asarray(imag, dtype=jnp.float32)
    if xr.shape != xi.shape:
        raise ValueError(f"irfftn: real and imag shapes differ: {xr.shape} vs {xi.shape}")
    if xr.ndim == 0:
        raise ValueError("irfftn expects at least one axis")
    axes = _normalize_axes(xr.ndim, axes, "irfftn")
    last = axes[-1]
    hw = xr.shape[last]
    w = 2 * (hw - 1)
    if hw < 2 or w & (w - 1):
        raise ValueError(
            f"irfftn: last axis must hold n//2 + 1 bins of a power-of-two n, "
            f"got {hw} bins"
        )
    rest = axes[:-1]
    if rest:
        # Unnormalized inverse over the complex axes; their 1/prod scale is
        # applied on the HALF-width spectrum (cheaper than after expansion).
        xr, xi = fftn_device(xr, xi, axes=rest, sign=+1)
        s = jnp.float32(1.0 / np.prod([xr.shape[a] for a in rest]))
        xr, xi = xr * s, xi * s
    mr = jnp.moveaxis(xr, last, -1)
    mi = jnp.moveaxis(xi, last, -1)
    lead = mr.shape[:-1]
    b = int(np.prod(lead)) if lead else 1
    out = irfft_device(mr.reshape(b, hw), mi.reshape(b, hw))  # carries 1/w
    return jnp.moveaxis(out.reshape(*lead, w), -1, last)


def rfftn(x, axes=None):
    """Host-convenience one-sided N-D FFT; see :func:`rfftn_device`."""
    yr, yi = rfftn_device(np.asarray(x, dtype=np.float32), axes=axes)
    return np.asarray(yr), np.asarray(yi)


def irfftn(real, imag, axes=None):
    """Host-convenience inverse of :func:`rfftn`; see :func:`irfftn_device`."""
    return np.asarray(
        irfftn_device(
            np.asarray(real, dtype=np.float32),
            np.asarray(imag, dtype=np.float32),
            axes=axes,
        )
    )


def hfftn_device(real, imag, axes=None):
    """N-D FFT of a Hermitian-symmetric signal -> REAL spectrum
    (``scipy.fft.hfftn`` semantics, even last-axis output length).

    ``real, imag``: the ``n//2 + 1`` unique last-axis samples of the
    Hermitian signal (power-of-two n), full complex samples on the other
    named axes.  Uses the identity ``hfftn(a) = irfftn(conj(a)) * prod(n)``
    so the whole transform rides the real-output Hermitian-fold dispatch
    (``kernels/large.py:inverse_real``) — the same path as 1-D
    :func:`gpu_fft_tpu.hfft`.  Returns the real f32 spectrum with the last
    named axis expanded to ``2 * (bins - 1)``, unnormalized.
    """
    import jax.numpy as jnp

    xr = jnp.asarray(real, dtype=jnp.float32)
    xi = jnp.asarray(imag, dtype=jnp.float32)
    if xr.shape != xi.shape:
        raise ValueError(f"hfftn: real and imag shapes differ: {xr.shape} vs {xi.shape}")
    if xr.ndim == 0:
        raise ValueError("hfftn expects at least one axis")
    naxes = _normalize_axes(xr.ndim, axes, "hfftn")
    last = naxes[-1]
    hw = xr.shape[last]
    w = 2 * (hw - 1)
    if hw < 2 or w & (w - 1):
        raise ValueError(
            f"hfftn: last axis must hold n//2 + 1 samples of a power-of-two n, "
            f"got {hw} samples"
        )
    prod = float(w) * float(np.prod([xr.shape[a] for a in naxes[:-1]] or [1.0]))
    out = irfftn_device(xr, -xi, axes=naxes)
    return out * jnp.float32(prod)


def ihfftn_device(x, axes=None):
    """Inverse of :func:`hfftn_device`: real spectrum -> the one-sided
    Hermitian signal (``scipy.fft.ihfftn``: ``conj(rfftn(x)) / prod(n)``).

    Returns split-complex (re, im) with the last named axis reduced to
    ``n//2 + 1`` unique samples; power-of-two lengths ride the half-spectrum
    forward dispatch, other lengths on the non-last axes run Bluestein.
    """
    import jax.numpy as jnp

    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim == 0:
        raise ValueError("ihfftn expects at least one axis")
    naxes = _normalize_axes(x.ndim, axes, "ihfftn")
    w = x.shape[naxes[-1]]
    if w < 2 or w & (w - 1):
        raise ValueError(f"ihfftn: last axis length {w} is not a power of two >= 2")
    rr, ri = rfftn_device(x, axes=naxes)
    s = jnp.float32(1.0 / np.prod([x.shape[a] for a in naxes]))
    return rr * s, -(ri * s)


def hfft2(real, imag, axes=(-2, -1)):
    """2-D Hermitian-input FFT (``scipy.fft.hfft2``); see :func:`hfftn_device`."""
    return np.asarray(
        hfftn_device(
            np.asarray(real, dtype=np.float32),
            np.asarray(imag, dtype=np.float32),
            axes=axes,
        )
    )


def ihfft2(x, axes=(-2, -1)):
    """2-D inverse of :func:`hfft2` (``scipy.fft.ihfft2``); see :func:`ihfftn_device`."""
    yr, yi = ihfftn_device(np.asarray(x, dtype=np.float32), axes=axes)
    return np.asarray(yr), np.asarray(yi)


def hfftn(real, imag, axes=None):
    """Host-convenience N-D Hermitian-input FFT; see :func:`hfftn_device`."""
    return np.asarray(
        hfftn_device(
            np.asarray(real, dtype=np.float32),
            np.asarray(imag, dtype=np.float32),
            axes=axes,
        )
    )


def ihfftn(x, axes=None):
    """Host-convenience inverse of :func:`hfftn`; see :func:`ihfftn_device`."""
    yr, yi = ihfftn_device(np.asarray(x, dtype=np.float32), axes=axes)
    return np.asarray(yr), np.asarray(yi)
