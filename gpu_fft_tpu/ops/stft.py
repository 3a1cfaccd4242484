"""Invertible short-time Fourier transform (STFT / ISTFT).

Extension beyond the reference surface (it ships magnitude analysis only —
``spectrogram`` here covers that): ``stft`` returns the COMPLEX one-sided
frame spectra and ``istft`` reconstructs the signal by windowed overlap-add
with per-sample window-power normalization (WOLA).  Because the synthesis
stage weights each frame by the analysis window and divides by the
accumulated window power, reconstruction is EXACT (to f32 rounding) at every
sample the frames cover with nonzero window power — no COLA constraint on
the hop is required.

All frame transforms ride the library's single-pass batched device FFT (the
launch-amortization pattern of reference ``src/fft.rs:191-205``): one
gather -> one batched rfft for analysis, one batched irfft -> one
scatter-add for synthesis.
"""

from __future__ import annotations

from math import gcd as _gcd

import numpy as np

__all__ = [
    "check_COLA",
    "check_NOLA",

    "stft",
    "istft",
    "stft_device",
    "istft_device",
    "stft_scipy",
    "istft_scipy",
    "window_table",
    "frame_signal",
]

# Above this many static slices the slice-framing form would bloat compile
# time; the gather form (slow but O(1) ops) takes over.  Reached only with
# near-coprime (frame, hop) pairs — every power-of-two hop stays well under.
_MAX_SLICES = 256

def _symmetric_table(window, m: int) -> np.ndarray:
    """Symmetric window of ``m`` samples, f64 (scipy fftbins=False form) —
    any name/tuple/float :func:`gpu_fft_tpu.ops.windows.get_window` accepts."""
    if m <= 1:
        return np.ones(max(m, 0))
    if window == "rect":  # library-local alias kept for the reference API
        return np.ones(m)
    from .windows import get_window

    return np.asarray(get_window(window, m, fftbins=False), dtype=np.float64)


def window_table(window, frame_size: int) -> np.ndarray:
    """Periodic (DFT-even) window of ``frame_size`` samples as f32.

    ``window``: None/"rect", any ``scipy.signal.windows`` family name,
    ``(name, *params)`` tuple, or bare float (kaiser beta) — see
    :mod:`gpu_fft_tpu.ops.windows`.  Accepted by every windowed estimator
    (stft/welch/csd/coherence/periodogram/spectrogram).
    Periodic form (the symmetric window of frame_size+1 samples with the
    last dropped — scipy's fftbins=True) is the correct choice for
    spectral analysis and overlap-add.

    >>> window_table("hann", 4).tolist()
    [0.0, 0.5, 1.0, 0.5]
    >>> window_table(None, 3).tolist()
    [1.0, 1.0, 1.0]
    """
    if window is None or window == "rect":
        return np.ones(frame_size, dtype=np.float32)
    if frame_size <= 1:  # degenerate: scipy returns ones
        return np.ones(max(frame_size, 0), dtype=np.float32)
    return _symmetric_table(window, frame_size + 1)[:frame_size].astype(np.float32)


def frame_signal(x, frame_size: int, hop: int, num_frames: int):
    """Extract (num_frames, frame_size) overlapping windows of a 1-D signal.

    Gather-free: the frames are built
    from ``frame_size // gcd(frame_size, hop)`` STATIC strided slices of the
    gcd-chunked signal instead: frames[m] = chunks[m*s + j] for j in
    0..c-1, and for fixed j the m-sweep is one stride-s slice.
    """
    import jax.numpy as jnp

    g = _gcd(frame_size, hop)
    c = frame_size // g
    if c > _MAX_SLICES:  # pathological (frame, hop): fall back to the gather
        idx = jnp.arange(num_frames)[:, None] * hop + jnp.arange(frame_size)[None, :]
        return x[idx]
    s = hop // g
    total = (num_frames - 1) * hop + frame_size
    chunks = x[:total].reshape(-1, g)  # ((num-1)*s + c, g)
    last = (num_frames - 1) * s
    cols = [chunks[j : j + last + 1 : s] for j in range(c)]  # each (num, g)
    return jnp.stack(cols, axis=1).reshape(num_frames, frame_size)


def frame_signal_unordered(x, frame_size: int, hop: int, num_frames: int):
    """:func:`frame_signal` for ORDER-FREE consumers (welch/csd/coherence,
    which only reduce over the segment axis): frames come back grouped by
    start-offset residue class instead of time order.

    When ``hop`` divides ``frame_size``, frames m = g + j*c (c = frame_size
    // hop) of residue g start at ``g*hop + j*frame_size`` — a CONTIGUOUS
    reshape.  The whole framing is then c reshapes + one concatenate
    (contiguous row writes at stream rate) instead of frame_signal's
    interleaved stack.  Other (frame, hop) shapes fall back to the ordered
    path.
    """
    import jax.numpy as jnp

    if hop <= 0 or frame_size % hop:
        return frame_signal(x, frame_size, hop, num_frames)
    c = frame_size // hop
    groups = []
    for g in range(min(c, num_frames)):
        cnt = (num_frames - 1 - g) // c + 1
        start = g * hop
        groups.append(x[start : start + cnt * frame_size].reshape(cnt, frame_size))
    return groups[0] if len(groups) == 1 else jnp.concatenate(groups, axis=0)


def overlap_add(frames, hop: int, total: int):
    """Sum (num_frames, frame_size) rows into a length-``total`` signal at
    ``hop`` spacing: out[m*hop + t] += frames[m, t].

    Scatter-free: instead of a flat ``.at[idx].add``, each of the
    ``frame_size // gcd`` chunk columns is placed by ONE ``lax.pad`` with
    interior (dilation) padding — stride-s placement as a vector op — and
    the contributions summed.
    """
    import jax.numpy as jnp
    from jax import lax

    num_frames, frame_size = frames.shape
    g = _gcd(frame_size, hop)
    c = frame_size // g
    span = (num_frames - 1) * hop + frame_size
    if c > _MAX_SLICES:
        idx = (
            jnp.arange(num_frames)[:, None] * hop + jnp.arange(frame_size)[None, :]
        ).reshape(-1)
        out = jnp.zeros(span, frames.dtype).at[idx].add(frames.reshape(-1))
    else:
        s = hop // g
        rows = (num_frames - 1) * s + c  # chunk rows of the output
        f3 = frames.reshape(num_frames, c, g)
        acc = None
        for j in range(c):
            # Rows j, j+s, j+2s, ... — lax.pad with interior s-1 dilates the
            # num_frames rows to that exact stride; low/high pads position j.
            placed = lax.pad(
                f3[:, j],
                jnp.float32(0),
                [(j, rows - j - ((num_frames - 1) * s + 1), s - 1), (0, 0, 0)],
            )
            acc = placed if acc is None else acc + placed
        out = acc.reshape(rows * g)[:span]
    if total <= span:
        return out[:total]
    return jnp.pad(out, (0, total - span))


def _check_framing(frame_size: int, hop: int | None) -> int:
    if frame_size < 2 or frame_size & (frame_size - 1):
        raise ValueError(f"frame_size must be a power of two >= 2, got {frame_size}")
    hop = frame_size // 2 if hop is None else hop
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    return hop


def stft_device(x, frame_size: int, hop: int | None = None, window: str | None = "hann"):
    """Complex one-sided STFT (device, jit-composable).

    ``x``: (n_samples,) real f32, or (channels, n_samples) for multi-channel
    input; ``frame_size``: power of two; ``hop`` defaults to
    frame_size // 2 (50% overlap).  Returns split-complex ``(real, imag)``
    arrays of shape (num_frames, frame_size // 2 + 1) — with a leading
    channel axis for 2-D input; ALL channels ride one batched transform.
    Frames that would run past the end of the signal are dropped (same
    framing as :func:`gpu_fft_tpu.spectrogram_device`).
    """
    import jax
    import jax.numpy as jnp

    from .transform import rfft_device

    hop = _check_framing(frame_size, hop)
    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim not in (1, 2):
        raise ValueError(f"stft expects a 1-D signal or (channels, n), got shape {x.shape}")
    n = x.shape[-1]
    num_frames = (n - frame_size) // hop + 1
    if num_frames < 1:
        raise ValueError(f"signal of {n} samples is shorter than one {frame_size} frame")
    w = window_table(window, frame_size)
    if x.ndim == 2:
        c = x.shape[0]
        frames = jax.vmap(lambda row: frame_signal(row, frame_size, hop, num_frames))(x)
        fr, fi = rfft_device(frames.reshape(c * num_frames, frame_size) * w[None])
        h = frame_size // 2 + 1
        return fr.reshape(c, num_frames, h), fi.reshape(c, num_frames, h)
    frames = frame_signal(x, frame_size, hop, num_frames)
    return rfft_device(frames * w[None])


def istft_device(
    real,
    imag,
    hop: int | None = None,
    window: str | None = "hann",
    length: int | None = None,
):
    """Inverse STFT by windowed overlap-add (device, jit-composable).

    ``real, imag``: (num_frames, frame_size // 2 + 1) split-complex frame
    spectra (the direct output of :func:`stft_device`, same ``hop`` and
    ``window``).  Each reconstructed frame is weighted by the synthesis
    window (= the analysis window) and the accumulation is divided by the
    per-sample window power, so ``istft(stft(x)) == x`` to f32 rounding at
    every covered sample.  ``length`` trims/zero-pads the tail (pass the
    original signal length).
    """
    import jax
    import jax.numpy as jnp

    real = jnp.asarray(real, dtype=jnp.float32)
    imag = jnp.asarray(imag, dtype=jnp.float32)
    if real.shape != imag.shape or real.ndim not in (2, 3):
        raise ValueError(
            f"istft expects matching (num_frames, bins) or (channels, num_frames, bins) "
            f"arrays, got {real.shape} vs {imag.shape}"
        )
    if real.ndim == 3:  # multi-channel: one synthesis per channel
        return jax.vmap(lambda r, i: istft_device(r, i, hop, window, length))(real, imag)
    num_frames, h = real.shape
    frame_size = 2 * (h - 1)
    if h < 2 or frame_size & (frame_size - 1):
        raise ValueError(f"istft: expected frame_size//2 + 1 bins of a power of two, got {h}")
    hop = _check_framing(frame_size, hop)

    from .transform import irfft_device

    frames = irfft_device(real, imag)  # (num_frames, frame_size)
    return _wola_frames(frames, hop, window, length)


def _wola_frames(frames, hop: int, window, length: int | None):
    """Window-weighted overlap-add of TIME-DOMAIN frames with per-sample
    window-power normalization — the synthesis half shared by
    :func:`istft_device` and :func:`istft_scipy`."""
    import jax.numpy as jnp

    num_frames, frame_size = frames.shape
    w = window_table(window, frame_size)
    total = (num_frames - 1) * hop + frame_size
    acc = overlap_add(frames * w[None], hop, total)
    wsq = np.zeros(total, dtype=np.float64)
    w64 = w.astype(np.float64)
    for f in range(num_frames):  # host-side: window power is a static table
        wsq[f * hop : f * hop + frame_size] += w64 * w64
    den = np.where(wsq > 1e-10, wsq, 1.0).astype(np.float32)
    y = acc / den
    if length is not None:
        if length <= total:
            y = y[:length]
        else:
            y = jnp.pad(y, (0, length - total))
    return y


def stft(x, frame_size: int, hop: int | None = None, window: str | None = "hann"):
    """Host-convenience STFT; see :func:`stft_device`.  Returns NumPy arrays."""
    r, i = stft_device(np.asarray(x, dtype=np.float32), frame_size, hop, window)
    return np.asarray(r), np.asarray(i)


def istft(
    real,
    imag,
    hop: int | None = None,
    window: str | None = "hann",
    length: int | None = None,
):
    """Host-convenience inverse STFT; see :func:`istft_device`."""
    return np.asarray(
        istft_device(
            np.asarray(real, dtype=np.float32),
            np.asarray(imag, dtype=np.float32),
            hop,
            window,
            length,
        )
    )


def stft_scipy(
    x,
    fs: float = 1.0,
    window="hann",
    nperseg: int = 256,
    noverlap: int | None = None,
    nfft: int | None = None,
    boundary: str | None = "zeros",
    padded: bool = True,
):
    """Drop-in ``scipy.signal.stft``: returns ``(f, t, (Zr, Zi))``.

    scipy conventions: hann window, ``noverlap`` defaults to nperseg // 2,
    the signal is extended by nperseg // 2 zeros on both ends
    (``boundary="zeros"``; None disables) and zero-padded to a whole
    number of frames (``padded``), the frame spectra are scaled by
    1 / sum(window) ('spectrum' scaling), and ``Zxx`` is oriented
    (bins, num_frames) like scipy's.  ``nfft`` >= nperseg zero-pads each
    windowed frame for a finer bin grid.  One divergence: a signal
    shorter than ``nperseg`` raises (scipy warns and silently shrinks
    nperseg, which would break the power-of-two contract here).
    Inverse: :func:`istft_scipy`.  Split-complex NumPy out.
    """
    import jax.numpy as jnp

    xv = np.asarray(x, dtype=np.float32)
    if xv.ndim != 1:
        raise ValueError(f"stft_scipy expects a 1-D signal, got shape {xv.shape}")
    if nperseg < 2 or nperseg & (nperseg - 1):
        raise ValueError(f"nperseg must be a power of two >= 2, got {nperseg}")
    nfft = nperseg if nfft is None else nfft
    if nfft < nperseg or nfft & (nfft - 1):
        raise ValueError(f"nfft must be a power of two >= nperseg, got {nfft}")
    noverlap = nperseg // 2 if noverlap is None else noverlap
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"noverlap must be in [0, nperseg), got {noverlap}")
    if boundary not in (None, "zeros"):
        raise ValueError(f"boundary must be 'zeros' or None, got {boundary!r}")
    hop = nperseg - noverlap
    half = nperseg // 2
    if xv.shape[0] < nperseg:
        raise ValueError(
            f"signal of {xv.shape[0]} samples is shorter than one {nperseg} segment"
        )
    ext = np.pad(xv, (half, half)) if boundary == "zeros" else xv
    if padded:
        num = -(-(ext.shape[0] - nperseg) // hop) + 1
        ext = np.pad(ext, (0, (num - 1) * hop + nperseg - ext.shape[0]))
    else:
        num = (ext.shape[0] - nperseg) // hop + 1
    w = window_table(window, nperseg)
    frames = frame_signal(jnp.asarray(ext), nperseg, hop, num) * w[None]
    if nfft > nperseg:
        frames = jnp.pad(frames, ((0, 0), (0, nfft - nperseg)))
    from .transform import rfft_device

    zr, zi = rfft_device(frames)
    s = np.float32(1.0 / w.sum())
    freqs = np.arange(nfft // 2 + 1, dtype=np.float64) * (fs / nfft)
    t0 = 0.0 if boundary == "zeros" else half
    times = (t0 + hop * np.arange(num)) / fs
    return freqs, times, (np.asarray(zr).T * s, np.asarray(zi).T * s)


def istft_scipy(
    zr,
    zi,
    fs: float = 1.0,
    window="hann",
    nperseg: int | None = None,
    noverlap: int | None = None,
    boundary: bool = True,
):
    """Inverse of :func:`stft_scipy` (``scipy.signal.istft`` semantics).

    ``zr, zi``: (bins, num_frames) split-complex spectra (scipy's Zxx
    orientation — the direct output of :func:`stft_scipy`).  Returns
    ``(t, x)``.  Undoes the 1/sum(window) scaling, synthesizes by the
    library's WOLA overlap-add (window-weighted accumulation divided by
    per-sample window power — scipy's formula), and trims the
    nperseg // 2 boundary extension when ``boundary`` is True.
    """
    zr = np.asarray(zr, dtype=np.float32).T  # scipy (bins, frames) -> rows
    zi = np.asarray(zi, dtype=np.float32).T
    if zr.shape != zi.shape or zr.ndim != 2:
        raise ValueError(
            f"istft_scipy expects matching (bins, num_frames) arrays, got "
            f"{zr.T.shape} vs {zi.T.shape}"
        )
    bins = zr.shape[1]
    nfft = 2 * (bins - 1)
    nperseg = nfft if nperseg is None else nperseg
    if nperseg < 2 or nperseg & (nperseg - 1):
        raise ValueError(f"nperseg must be a power of two >= 2, got {nperseg}")
    if nperseg > nfft:
        raise ValueError(
            f"nperseg ({nperseg}) exceeds the {bins}-bin spectra's nfft ({nfft})"
        )
    noverlap = nperseg // 2 if noverlap is None else noverlap
    # Mirror stft_scipy's contract: noverlap >= nperseg would mean hop <= 0,
    # which otherwise surfaces as a confusing zero-step slice deep inside
    # the overlap-add synthesis.
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"noverlap must be in [0, nperseg), got {noverlap}")
    hop = nperseg - noverlap
    w = window_table(window, nperseg)
    s = np.float32(w.sum())
    num = zr.shape[0]
    full = (num - 1) * hop + nperseg
    if nfft > nperseg:
        # Finer-grid spectra: recover the nperseg-sample frames by inverse
        # transform at nfft + truncation (the forward only zero-padded),
        # then synthesize those frames directly — no re-analysis pass.
        from .transform import irfft_device

        frames = irfft_device(zr * s, zi * s)[:, :nperseg]
        y = np.asarray(_wola_frames(frames, hop, window, full))
    else:
        y = np.asarray(istft_device(zr * s, zi * s, hop=hop, window=window, length=full))
    half = nperseg // 2
    if boundary:
        y = y[half : full - half]
    times = np.arange(y.shape[0], dtype=np.float64) / fs
    return times, y


def check_COLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """Constant-overlap-add check (``scipy.signal.check_COLA``): the
    hop-shifted window copies must sum to a constant for perfect
    weighted-overlap-add ISTFT reconstruction."""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1:
        raise ValueError("nperseg must be a positive integer")
    if not 0 <= noverlap < nperseg:
        raise ValueError("noverlap must be in [0, nperseg)")
    win = _check_window_f64(window, nperseg)
    step = nperseg - noverlap
    binsums = sum(win[i * step:(i + 1) * step] for i in range(nperseg // step))
    if nperseg % step != 0:
        binsums[:nperseg % step] += win[-(nperseg % step):]
    return bool(np.max(np.abs(binsums - binsums[0])) < tol)


def _check_window_f64(window, nperseg: int) -> np.ndarray:
    """Full-precision periodic window for the COLA/NOLA gates (the f32
    window_table would alias its own rounding into the tolerance)."""
    if isinstance(window, (str, tuple)) or window is None:
        if window is None or window == "rect":
            return np.ones(nperseg)
        return _symmetric_table(window, nperseg + 1)[:nperseg]
    win = np.asarray(window, dtype=np.float64)
    if win.shape != (nperseg,):
        raise ValueError("window must have length nperseg")
    return win


def check_NOLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """Nonzero-overlap-add check (``scipy.signal.check_NOLA``): the sum of
    SQUARED shifted windows must be bounded away from zero everywhere —
    the weaker invertibility condition the ISTFT normalization needs."""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1:
        raise ValueError("nperseg must be a positive integer")
    if not 0 <= noverlap < nperseg:
        raise ValueError("noverlap must be in [0, nperseg)")
    win = _check_window_f64(window, nperseg)
    step = nperseg - noverlap
    w2 = win * win
    binsums = sum(w2[i * step:(i + 1) * step] for i in range(nperseg // step))
    if nperseg % step != 0:
        binsums[:nperseg % step] += w2[-(nperseg % step):]
    return bool(np.min(binsums) > tol * np.max(w2))


def _dual_canonical_window(win: np.ndarray, hop: int) -> np.ndarray:
    """Canonical WOLA dual: win / (per-position sum of |win|^2 over all
    hop-shifted copies); raises when the frame is not invertible."""
    w2 = win.real ** 2 + win.imag ** 2
    dd = w2.copy()
    for k in range(hop, win.size, hop):
        dd[k:] += w2[:-k]
        dd[:-k] += w2[k:]
    if not np.all(dd >= np.finfo(np.float64).resolution * dd.max()):
        raise ValueError("short-time Fourier transform not invertible for this "
                         "window/hop (zero frame-overlap energy somewhere)")
    return win / dd


def closest_STFT_dual_window(win, hop: int, desired_dual=None, *, scaled: bool = True):
    """Dual STFT window closest to a desired one
    (``scipy.signal.closest_STFT_dual_window``): the canonical dual plus
    the component of (desired − projection) in the dual space; with
    ``scaled`` the optimal scale factor alpha is solved for and returned."""
    win = np.asarray(win)
    desired_dual = np.ones_like(win) if desired_dual is None else np.asarray(desired_dual)
    if win.ndim != 1 or win.shape != desired_dual.shape:
        raise ValueError("win and desired_dual must be equal-length 1-D arrays")
    if not (np.all(np.isfinite(win)) and np.all(np.isfinite(desired_dual))):
        raise ValueError("win and desired_dual must be finite")
    if not (isinstance(hop, (int, np.integer)) and 1 <= hop <= win.size):
        raise ValueError(f"hop must be an integer in [1, {win.size}], got {hop!r}")
    w_d = _dual_canonical_window(win.astype(np.result_type(win.dtype, np.float64)), hop)
    wdd = np.conj(win) * desired_dual
    q_d = wdd.copy()
    for k in range(hop, win.size, hop):
        q_d[k:] += wdd[:-k]
        q_d[:-k] += wdd[k:]
    q_d = w_d * q_d
    if not scaled:
        return w_d + desired_dual - q_d, 1.0
    numerator = np.conj(q_d) @ w_d
    denominator = q_d.real @ q_d.real + q_d.imag @ q_d.imag
    if not (abs(numerator) > 0 and denominator > np.finfo(np.float64).resolution):
        raise ValueError("scaled dual window numerically unstable; use scaled=False")
    alpha = numerator / denominator
    return w_d + alpha * (desired_dual - q_d), alpha
