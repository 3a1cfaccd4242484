"""DSP convenience ops built on the transforms: convolution and shifts.

Extensions beyond the reference's surface (it ships only PSD + frequency
helpers).  ``fft_convolve`` is the classic FFT-accelerated linear
convolution through this library's pow2 path; the shift helpers mirror
``numpy.fft.fftshift``/``ifftshift`` and are device-capable.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "hilbert2",
    "gauss_spline",

    "detrend",
    "correlation_lags",
    "vectorstrength",
    "deconvolve",

    "fft_convolve",
    "fft_convolve_device",
    "fft_correlate",
    "fftshift",
    "ifftshift",
    "hilbert",
    "hilbert_device",
    "envelope",
    "envelope_device",
    "resample",
    "resample_device",
]


def fft_convolve_device(a, b):
    """Device-resident full linear convolution of batched real rows.

    ``a``: (B, la) and ``b``: (B, lb) f32 device arrays; a 1-D operand is
    broadcast across the other's batch.  Returns the (B, la+lb-1) full
    convolution — or 1-D when BOTH inputs were 1-D, matching the host
    :func:`fft_convolve`.  Host-side slicing conveniences (same/valid) live
    there too.
    """
    import jax.numpy as jnp

    from ..config import MAX_N
    from ..kernels.large import transform_any
    from .transform import next_power_of_two

    a = jnp.asarray(a, dtype=jnp.float32)
    b = jnp.asarray(b, dtype=jnp.float32)
    squeeze = a.ndim == 1 and b.ndim == 1
    if a.ndim == 1:
        a = a[None]
    if b.ndim == 1:
        b = b[None]
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(
            f"fft_convolve_device expects 1-D or (B, l) inputs, got {a.shape} vs {b.shape}"
        )
    if a.shape[0] != b.shape[0]:
        if a.shape[0] == 1:
            a = jnp.broadcast_to(a, (b.shape[0], a.shape[1]))
        elif b.shape[0] == 1:
            b = jnp.broadcast_to(b, (a.shape[0], b.shape[1]))
        else:
            raise ValueError(
                f"fft_convolve_device: batch sizes differ: {a.shape[0]} vs {b.shape[0]}"
            )
    if a.shape[1] == 0 or b.shape[1] == 0:
        raise ValueError("fft_convolve_device expects non-empty signals")
    la, lb = a.shape[1], b.shape[1]
    lfull = la + lb - 1
    m = max(2, next_power_of_two(lfull))
    if m > MAX_N:
        raise ValueError(
            f"fft_convolve_device: combined length {lfull} needs a {m}-point "
            f"transform, beyond the supported maximum {MAX_N}"
        )
    pa = jnp.pad(a, ((0, 0), (0, m - la)))
    pb = jnp.pad(b, ((0, 0), (0, m - lb)))
    ar, ai = transform_any(pa, None, m, -1)
    br, bi = transform_any(pb, None, m, -1)
    cr = ar * br - ai * bi
    ci = ar * bi + ai * br
    # Real-output inverse with the Hermitian-fold dispatch (1/m in-table).
    from ..kernels.large import inverse_real

    yr = inverse_real(cr, ci, m, scale=1.0 / m)
    out = yr[:, :lfull]
    return out[0] if squeeze else out


def fft_convolve(a, b, mode: str = "full"):
    """Linear convolution of two real 1-D signals via the pow2 FFT path.

    ``mode``: "full" (len la+lb-1, default), "same" (len la, centered), or
    "valid" (len la-lb+1, only fully-overlapping samples; requires
    la >= lb).  Matches ``numpy.convolve`` up to f32 rounding.

    >>> fft_convolve([1.0, 2.0, 3.0], [1.0, 1.0]).round(5).tolist()
    [1.0, 3.0, 5.0, 3.0]
    >>> fft_convolve([1.0, 2.0, 3.0], [1.0, 1.0], mode="same").round(5).tolist()
    [1.0, 3.0, 5.0]
    >>> fft_convolve([1.0, 2.0, 3.0], [1.0, 1.0], mode="valid").round(5).tolist()
    [3.0, 5.0]
    """
    import jax.numpy as jnp

    from ..config import MAX_N
    from ..kernels.large import transform_any
    from .transform import next_power_of_two

    av = np.asarray(a, dtype=np.float32)
    bv = np.asarray(b, dtype=np.float32)
    if av.ndim != 1 or bv.ndim != 1 or av.size == 0 or bv.size == 0:
        raise ValueError("fft_convolve expects two non-empty 1-D signals")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be full|same|valid, got {mode!r}")
    la, lb = av.shape[0], bv.shape[0]
    if mode == "valid" and la < lb:
        raise ValueError("valid mode requires len(a) >= len(b)")
    lfull = la + lb - 1
    m = max(2, next_power_of_two(lfull))
    if m > MAX_N:
        raise ValueError(
            f"fft_convolve: combined length {lfull} needs a {m}-point transform, "
            f"beyond the supported maximum {MAX_N}"
        )
    # Both signals ride ONE batched forward pass (the library's own
    # launch-amortization pattern).
    pair = np.zeros((2, m), dtype=np.float32)
    pair[0, :la] = av
    pair[1, :lb] = bv
    fr, fi = transform_any(jnp.asarray(pair), None, m, -1)
    cr = fr[0] * fr[1] - fi[0] * fi[1]
    ci = fr[0] * fi[1] + fi[0] * fr[1]
    from ..kernels.large import inverse_real

    yr = inverse_real(cr[None], ci[None], m, scale=1.0 / m)
    full = np.asarray(yr[0])[:lfull]
    if mode == "full":
        return full
    if mode == "same":
        # numpy.convolve 'same': length max(la, lb), centered on 'full'.
        out_len = max(la, lb)
        start = (min(la, lb) - 1) // 2
        return full[start : start + out_len].copy()
    return full[lb - 1 : la].copy()


def fft_correlate(a, b, mode: str = "full"):
    """Cross-correlation of two real 1-D signals via the FFT path.

    Matches ``numpy.correlate(a, b, mode)`` (which slides the CONJUGATE-
    reversed ``b`` across ``a``) up to f32 rounding: correlation is
    convolution with the reversed kernel, so this reuses
    :func:`fft_convolve`'s single batched pow2 pass.  Autocorrelation is
    ``fft_correlate(x, x, "full")``.

    >>> fft_correlate([1.0, 2.0, 3.0], [0.0, 1.0, 0.5]).round(5).tolist()
    [0.5, 2.0, 3.5, 3.0, 0.0]
    >>> fft_correlate([1.0, 2.0, 3.0], [1.0, 2.0, 3.0], mode="valid").round(4).tolist()
    [14.0]
    """
    bv = np.asarray(b, dtype=np.float32)
    if bv.ndim != 1 or bv.size == 0:
        raise ValueError("fft_correlate expects two non-empty 1-D signals")
    if mode == "valid":
        # numpy.correlate 'valid' allows either operand to be the longer one.
        av = np.asarray(a, dtype=np.float32)
        if av.ndim != 1 or av.size == 0:
            raise ValueError("fft_correlate expects two non-empty 1-D signals")
        if av.shape[0] < bv.shape[0]:
            # correlate(a, b, 'valid') == correlate(b, a, 'valid')[::-1]
            return fft_correlate(bv, av, "valid")[::-1].copy()
    return fft_convolve(a, bv[::-1].copy(), mode=mode)


def hilbert_device(x):
    """Analytic signal of real rows via the FFT (device, jit-composable).

    ``x``: (n,) or (B, n) real f32, ANY length n >= 1 (non-pow2 lengths run
    exactly through the Bluestein path).  Returns split-complex
    ``(real, imag)`` of the analytic signal: real == x (up to rounding) and
    imag is the Hilbert transform — ``scipy.signal.hilbert`` semantics.
    """
    import jax.numpy as jnp

    from .exact import fft_exact_device, ifft_exact_device

    x = jnp.asarray(x, dtype=jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    if x.ndim != 2 or x.shape[-1] < 1:
        raise ValueError(f"hilbert expects non-empty 1-D or (B, n) input, got {x.shape}")
    n = x.shape[-1]
    yr, yi = fft_exact_device(x)
    # Analytic-signal spectrum gain: 1 at DC (and Nyquist when n is even),
    # 2 on positive frequencies, 0 on negative frequencies.
    h = np.zeros(n, dtype=np.float32)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[1 : (n + 1) // 2] = 2.0
    ar, ai = ifft_exact_device(yr * h, yi * h)
    return (ar[0], ai[0]) if squeeze else (ar, ai)


def hilbert(x):
    """Host-convenience analytic signal; see :func:`hilbert_device`.

    Returns ``(real, imag)`` NumPy arrays — imag is the Hilbert transform.
    """
    ar, ai = hilbert_device(np.asarray(x, dtype=np.float32))
    return np.asarray(ar), np.asarray(ai)


def envelope(x):
    """Instantaneous amplitude envelope |analytic signal| of a real signal.

    The classic demodulation primitive: for ``x(t) = a(t) * cos(w t)`` with a
    slowly-varying amplitude, returns ``a(t)``.
    """
    ar, ai = hilbert(x)
    return np.sqrt(ar * ar + ai * ai)


def envelope_device(x):
    """Device-resident amplitude envelope (jit-composable); see
    :func:`envelope`."""
    import jax.numpy as jnp

    ar, ai = hilbert_device(x)
    return jnp.hypot(ar, ai)


def resample_device(x, num: int):
    """Fourier-domain resampling of real rows to ``num`` samples (device).

    ``x``: (n,) or (B, n) real f32, any length.  Computes the exact length-n
    spectrum, truncates (downsample) or zero-pads (upsample) it symmetrically
    with the standard Nyquist-bin split/merge, and inverts at length num —
    ``scipy.signal.resample`` semantics for real input.  Assumes the signal
    is periodic (as that method does).
    """
    import jax.numpy as jnp

    from .exact import fft_exact_device, ifft_exact_device

    x = jnp.asarray(x, dtype=jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    if x.ndim != 2 or x.shape[-1] < 1:
        raise ValueError(f"resample expects non-empty 1-D or (B, n) input, got {x.shape}")
    if num < 1:
        raise ValueError(f"num must be >= 1, got {num}")
    n = x.shape[-1]
    yr, yi = fft_exact_device(x)
    b = yr.shape[0]
    nyq = min(n, num) // 2 + 1  # non-negative frequencies that survive

    # The new spectrum is assembled as ONE concatenation of slices — head
    # (non-negative bins), zero gap (upsample), tail (negative bins, which
    # are CONTIGUOUS slice copies X_new[num-j] = X_old[n-j], never
    # reversals) — instead of zeros-buffer scatter updates: each .at[].set
    # pass costs a full (B, num) VPU round-trip at B=1 dispatch-floor
    # prices, the concat is free inside the inverse's fusion.
    m = min(n, num)
    neg = m - nyq  # negative bins that survive
    head_r, head_i = yr[:, :nyq], yi[:, :nyq]
    if m % 2 == 0:
        sh = m // 2  # the shared Nyquist bin = the last head column
        if num < n:
            # Downsample: the old +num/2 and -num/2 bins alias onto the new
            # Nyquist bin; they sum (conjugates for real input -> 2*Re).
            head_r = jnp.concatenate(
                [head_r[:, :sh], (head_r[:, sh] + yr[:, n - sh])[:, None]], axis=1
            )
            head_i = jnp.concatenate(
                [head_i[:, :sh], (head_i[:, sh] + yi[:, n - sh])[:, None]], axis=1
            )
        elif num > n:
            # Upsample: split the old Nyquist across the two half-bins (the
            # mirror half-bin lands at the END of the zero gap below).
            head_r = jnp.concatenate([head_r[:, :sh], head_r[:, sh:] * 0.5], axis=1)
            head_i = jnp.concatenate([head_i[:, :sh], head_i[:, sh:] * 0.5], axis=1)
    parts_r, parts_i = [head_r], [head_i]
    gap = num - nyq - neg
    if gap > 0:
        split = num > n and m % 2 == 0  # mirror half-bin occupies the last slot
        zeros = jnp.zeros((b, gap - (1 if split else 0)), jnp.float32)
        parts_r.append(zeros)
        parts_i.append(zeros)
        if split:
            sh = m // 2
            parts_r.append((yr[:, sh] * 0.5)[:, None])
            parts_i.append((yi[:, sh] * 0.5)[:, None])
    if neg > 0:
        parts_r.append(yr[:, n - neg :])
        parts_i.append(yi[:, n - neg :])
    zr = jnp.concatenate(parts_r, axis=1)
    zi = jnp.concatenate(parts_i, axis=1)
    if num >= 2 and num & (num - 1) == 0:
        # Real output + pow2 target: the real-output fold dispatch
        # (kernels/large.py:inverse_real) reads only the k1 <= n1/2 grid
        # columns at fold sizes, so the negative-bin copies feeding unread
        # columns are dead-code-eliminated — half the inverse's matmuls
        # with the SAME contiguous spectrum construction (the negative bins
        # are contiguous slice copies, never reversals).
        from ..kernels.large import inverse_real

        out = inverse_real(zr, zi, num, scale=1.0 / n)
        return out[0] if squeeze else out
    rr, _ = ifft_exact_device(zr, zi)
    out = rr * jnp.float32(num / n)
    return out[0] if squeeze else out


def resample(x, num: int):
    """Host-convenience Fourier resampling; see :func:`resample_device`."""
    return np.asarray(resample_device(np.asarray(x, dtype=np.float32), num))


def fftshift(x, axes=None):
    """Move the zero-frequency bin to the center (``numpy.fft.fftshift``).

    Device-capable: jax arrays stay on device; other inputs go through
    NumPy.

    >>> fftshift(np.array([0.0, 1.0, 2.0, 3.0])).tolist()
    [2.0, 3.0, 0.0, 1.0]
    """
    import jax

    if isinstance(x, jax.Array):
        import jax.numpy as jnp

        return jnp.fft.fftshift(x, axes=axes)
    return np.fft.fftshift(np.asarray(x), axes=axes)


def ifftshift(x, axes=None):
    """Inverse of :func:`fftshift`.

    >>> ifftshift(fftshift(np.array([0.0, 1.0, 2.0, 3.0, 4.0]))).tolist()
    [0.0, 1.0, 2.0, 3.0, 4.0]
    """
    import jax

    if isinstance(x, jax.Array):
        import jax.numpy as jnp

        return jnp.fft.ifftshift(x, axes=axes)
    return np.fft.ifftshift(np.asarray(x), axes=axes)


def fftfreq(n: int, d: float = 1.0):
    """Sample frequencies of an n-point FFT (``numpy.fft.fftfreq``).

    >>> fftfreq(4, d=0.25).tolist()
    [0.0, 1.0, -2.0, -1.0]
    """
    if n < 1:
        raise ValueError(f"fftfreq requires n >= 1, got {n}")
    return np.fft.fftfreq(n, d=d).astype(np.float32)


def rfftfreq(n: int, d: float = 1.0):
    """Sample frequencies of an n-point one-sided rfft (``numpy.fft.rfftfreq``).

    >>> rfftfreq(8, d=0.125).tolist()
    [0.0, 1.0, 2.0, 3.0, 4.0]
    """
    if n < 1:
        raise ValueError(f"rfftfreq requires n >= 1, got {n}")
    return np.fft.rfftfreq(n, d=d).astype(np.float32)


def next_fast_len(target: int, real: bool = False):
    """Smallest transform length >= target that hits the library's fast path.

    Every transform here is a power-of-two matmul plan (the reference
    pads the same way: ``src/fft.rs:23-27``), so unlike
    ``scipy.fft.next_fast_len`` (5-smooth) this returns the next power of
    two.  ``real`` is accepted for scipy signature compatibility and does
    not change the answer.

    >>> next_fast_len(1000)
    1024
    >>> next_fast_len(1024)
    1024
    """
    from .transform import next_power_of_two

    if target < 1:
        raise ValueError(f"next_fast_len requires target >= 1, got {target}")
    return max(2, next_power_of_two(target))


def prev_fast_len(target: int, real: bool = False):
    """Largest transform length <= target that hits the library's fast path
    (``scipy.fft.prev_fast_len`` signature; power-of-two rule, the dual of
    :func:`next_fast_len`).

    >>> prev_fast_len(1000)
    512
    >>> prev_fast_len(1024)
    1024
    """
    if target < 2:
        raise ValueError(f"prev_fast_len requires target >= 2, got {target}")
    return 1 << (int(target).bit_length() - 1)


def hfft(input_real, input_imag):
    """FFT of a signal with Hermitian symmetry -> real spectrum
    (``numpy.fft.hfft`` with n = 2*(len(input)-1)).

    The time-domain signal is Hermitian (its h = n//2 + 1 unique samples
    are given), so its spectrum is REAL — computed as the real-output
    inverse path un-normalized: hfft(a) == irfft(conj(a)) * n, riding the
    Hermitian-fold dispatch (kernels/large.py:inverse_real).
    """
    from ..kernels.large import inverse_real

    import jax.numpy as jnp

    xr = np.asarray(input_real, dtype=np.float32)
    xi = np.asarray(input_imag, dtype=np.float32)
    if xr.shape != xi.shape or xr.ndim != 1:
        raise ValueError(
            f"hfft: real and imag must be equal-length 1-D arrays, got {xr.shape} vs {xi.shape}"
        )
    h = xr.shape[0]
    n = 2 * (h - 1)
    if h < 2 or n & (n - 1):
        raise ValueError(f"hfft: expected n//2 + 1 samples of a power-of-two n, got {h}")
    full_r = np.concatenate([xr, xr[1:-1][::-1]])
    full_i = np.concatenate([-xi, xi[1:-1][::-1]])  # conj, Hermitian-extended
    full_i[0] = 0.0
    full_i[h - 1] = 0.0
    out = inverse_real(jnp.asarray(full_r[None]), jnp.asarray(full_i[None]), n)
    return np.asarray(out[0])


def ihfft(input):
    """Inverse of :func:`hfft`: real spectrum -> the h = n//2 + 1 unique
    samples of the Hermitian time signal (``numpy.fft.ihfft`` semantics:
    returns the conjugate of the forward rfft / n).
    """
    from .transform import fft

    x = np.asarray(input, dtype=np.float32)
    if x.ndim != 1 or x.size < 2:
        raise ValueError(f"ihfft expects a 1-D real spectrum of length >= 2, got {x.shape}")
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"ihfft: length {n} is not a power of two")
    re, im = fft(x)
    h = n // 2 + 1
    s = np.float32(1.0 / n)
    return re[:h] * s, -im[:h] * s


def detrend(data, axis: int = -1, type: str = "linear", bp=0, overwrite_data: bool = False):
    """Remove a constant or piecewise-linear trend (``scipy.signal.detrend``).
    ``bp`` gives breakpoint indices for independently-fit linear segments.
    Host NumPy: detrending is a data-prep step, not a device hot loop (the
    spectral ops fuse their own detrend on device, ``ops/spectral.py``)."""
    data = np.asarray(data)
    if type not in ("linear", "l", "constant", "c"):
        raise ValueError("type must be 'linear' or 'constant'")
    res_dtype = np.float64 if data.dtype.kind in "iub" else data.dtype
    if type in ("constant", "c"):
        return data - np.mean(data, axis, keepdims=True)
    x = np.moveaxis(data.astype(res_dtype, copy=not overwrite_data), axis, 0)
    n = x.shape[0]
    bp = np.sort(np.unique(np.concatenate([[0], np.atleast_1d(bp), [n]])))
    if np.any(bp > n):
        raise ValueError("breakpoints must not exceed the axis length")
    flat = x.reshape(n, -1)
    for lo, hi in zip(bp[:-1], bp[1:]):
        m = int(hi - lo)
        if m == 0:
            continue
        t = np.arange(m, dtype=res_dtype)
        basis = np.stack([t / max(m, 1), np.ones(m, dtype=res_dtype)], axis=1)
        coef, *_ = np.linalg.lstsq(basis, flat[lo:hi], rcond=None)
        flat[lo:hi] -= basis @ coef
    return np.moveaxis(flat.reshape(x.shape), 0, axis)


def correlation_lags(in1_len: int, in2_len: int, mode: str = "full") -> np.ndarray:
    """Lag indices matching ``fft_correlate(in1, in2, mode)``
    (``scipy.signal.correlation_lags``)."""
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        lo = mid - in1_len // 2
        return lags[lo:lo + in1_len]
    if mode == "valid":
        if in1_len >= in2_len:
            return np.arange(in1_len - in2_len + 1)
        return np.arange(in1_len - in2_len, 1)
    raise ValueError(f"mode must be full|same|valid, got {mode!r}")


def vectorstrength(events, period):
    """Phase-locking strength of events to a period
    (``scipy.signal.vectorstrength``): resultant length and angle of the
    unit phasors exp(j·2π·event/period)."""
    events = np.asarray(events, dtype=np.float64)
    period = np.asarray(period, dtype=np.float64)
    scalar = period.ndim == 0
    period = np.atleast_1d(period)
    if events.ndim != 1:
        raise ValueError("events must be 1-D")
    if np.any(period <= 0):
        raise ValueError("periods must be positive")
    ang = 2.0 * np.pi * events[:, None] / period[None, :]
    vec = np.exp(1j * ang).mean(axis=0)
    strength, phase = np.abs(vec), np.angle(vec)
    return (float(strength[0]), float(phase[0])) if scalar else (strength, phase)


def deconvolve(signal, divisor):
    """Polynomial deconvolution (``scipy.signal.deconvolve``): quotient and
    remainder with ``signal = convolve(divisor, quotient) + remainder``."""
    num = np.atleast_1d(np.asarray(signal, dtype=np.float64))
    den = np.atleast_1d(np.asarray(divisor, dtype=np.float64))
    if num.ndim != 1 or den.ndim != 1:
        raise ValueError("signal and divisor must be 1-D")
    if den[0] == 0:
        raise ValueError("divisor must have a nonzero leading coefficient")
    n = num.size - den.size + 1
    if n <= 0:
        return np.zeros(1), num.copy()
    quot = np.empty(n, dtype=np.float64)
    rem = num.copy()
    for i in range(n):  # long division; n is the small filter-order scale
        q = rem[i] / den[0]
        quot[i] = q
        rem[i:i + den.size] -= q * den
    return quot, rem


def hilbert2(x, N=None, axes=(-2, -1)):
    """2-D analytic signal (``scipy.signal.hilbert2``): single-orthant
    spectrum — per axis, keep bin 0, double bins 1..(n+1)//2-1, zero the
    rest (scipy >= 1.17 semantics: even-n Nyquist is zeroed) — the
    separable product of two 1-D analytic-signal steps on the fft2 engine."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        raise ValueError("hilbert2 needs a real input")
    if x.ndim < 2:
        raise ValueError("hilbert2 needs an at-least-2-D input")
    if len(axes) != 2 or axes[0] == axes[1]:
        raise ValueError("axes must be two distinct axes")
    x = np.moveaxis(x.astype(np.float64), axes, (-2, -1))
    if N is None:
        N = x.shape[-2:]
    elif np.isscalar(N):
        N = (int(N), int(N))
    if len(N) != 2 or any(n <= 0 for n in N):
        raise ValueError("N must be two positive lengths")
    from .. import compat

    Xf = np.asarray(compat.fft2(x, s=tuple(N)))
    h = []
    for n in N:
        h1 = np.zeros(n)
        h1[0] = 1.0
        h1[1:(n + 1) // 2] = 2.0
        h.append(h1)
    out = np.asarray(compat.ifft2(Xf * np.outer(h[0], h[1])))
    return np.moveaxis(out, (-2, -1), axes)


def gauss_spline(x, n: int):
    """Gaussian approximation of the order-n B-spline
    (``scipy.signal.gauss_spline``): variance (n+1)/12."""
    x = np.asarray(x, dtype=np.float64)
    sig2 = (n + 1) / 12.0
    return np.exp(-x * x / (2.0 * sig2)) / np.sqrt(2.0 * np.pi * sig2)


def envelope_scipy(z, bp_in=(1, None), *, n_out=None, squared=False,
                   residual="lowpass", axis=-1):
    """Band-limited envelope + residual (``scipy.signal.envelope``,
    scipy >= 1.16): the envelope is |baseband| of the bp_in-band analytic
    signal; the residual is the out-of-band remainder ('lowpass' keeps
    only the below-band part, 'all' keeps everything outside the band).
    Rides the compat transforms (our engine) on the last axis."""
    from .. import compat

    z = np.asarray(z)
    if not -z.ndim <= axis < z.ndim:
        raise ValueError(f"invalid axis {axis} for shape {z.shape}")
    if z.shape[axis] == 0:
        raise ValueError("z must be non-empty along axis")
    if len(bp_in) != 2 or not all(b is None or isinstance(b, (int, np.integer))
                                  for b in bp_in):
        raise ValueError("bp_in must be a 2-tuple of int | None")
    if n_out is not None and (not isinstance(n_out, (int, np.integer)) or n_out <= 0):
        raise ValueError("n_out must be a positive int or None")
    if residual not in ("lowpass", "all", None):
        raise ValueError("residual must be 'lowpass', 'all' or None")
    n = z.shape[axis]
    n_out = n if n_out is None else int(n_out)
    fak = n_out / n
    lo = bp_in[0] if bp_in[0] is not None else -(n // 2)
    hi = bp_in[1] if bp_in[1] is not None else (n + 1) // 2
    if not -(n // 2) <= lo < hi <= (n + 1) // 2:
        raise ValueError(f"bp_in {bp_in} out of range for n={n}")
    z = np.moveaxis(z, axis, -1)
    complex_in = np.iscomplexobj(z)
    if complex_in:
        Z = np.array(compat.fft(z))  # writable copy — masked in place below
    else:
        Z = np.zeros(z.shape, dtype=complex)
        Z[..., : n // 2 + 1] = np.asarray(compat.rfft(z))
        if lo > 0:  # analytic within the band
            Z[..., lo:hi] *= 2
        elif hi > 0:
            Z[..., 1:hi] *= 2
    if not lo <= 0 < hi:
        z_bb = np.asarray(compat.ifft(Z[..., lo:hi], n=n_out)) * fak
    else:
        Zs = np.fft.fftshift(Z, axes=-1)
        z_bb = np.asarray(compat.ifft(Zs[..., lo + n // 2 : hi + n // 2], n=n_out)) * fak
    env = np.abs(z_bb) if not squared else z_bb.real ** 2 + z_bb.imag ** 2
    env = np.moveaxis(env, -1, axis)
    if residual is None:
        return env
    if not lo <= 0 < hi:
        Z[..., lo:hi] = 0
    else:
        Z[..., :hi] = 0
        Z[..., lo:] = 0
    if residual == "lowpass":
        if hi > 0:
            Z[..., hi : (n + 1) // 2] = 0
        else:
            Z[..., lo:] = 0
            Z[..., : (n + 1) // 2] = 0
    if complex_in:
        if n_out == n:
            z_res = np.asarray(compat.ifft(Z))
        else:
            # spectral resampling: move bins to the new grid, halving /
            # doubling the unpaired Nyquist-like bin as scipy's
            # resample(domain='freq') does
            m = min(n, n_out)
            Zr = np.zeros(z.shape[:-1] + (n_out,), dtype=complex)
            up = m // 2 + 1
            Zr[..., :up] = Z[..., :up]
            Zr[..., -(m - up):] = Z[..., -(m - up):] if m > up else 0
            if m % 2 == 0:
                if n_out < n:
                    Zr[..., m // 2] += Z[..., -(m // 2)]
                else:
                    Zr[..., m // 2] *= 0.5
                    Zr[..., -(m // 2)] = Zr[..., m // 2]
            z_res = np.asarray(compat.ifft(Zr)) * fak
    else:
        if n_out != n and (m := min(n, n_out)) % 2 == 0:
            Z[..., m // 2] *= 2 if n_out < n else 0.5
        z_res = fak * np.asarray(compat.irfft(Z[..., : n // 2 + 1], n=n_out))
    return np.stack((env, np.moveaxis(z_res, -1, axis)), axis=0)
