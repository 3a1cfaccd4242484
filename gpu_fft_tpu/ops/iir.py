"""IIR filtering (``lfilter`` / ``filtfilt`` / ``sosfilt``) on the device.

Extension beyond the reference surface.  An IIR recursion
``y[t] = sum_i b[i] x[t-i] - sum_j a[j] y[t-j]`` is sequential by
definition — the one shape a matmul engine cannot eat directly.  The
plain answer (scan over every sample) is a length-n ``lax.scan`` of
k-vector updates: n sequential steps.

This module instead uses the **block-state decomposition**: split the
signal into length-L blocks; inside a block the ZERO-STATE response is a
causal FIR convolution with the filter's impulse response truncated at L
(exact — in-block samples cannot see taps beyond L), which rides the
measured batched transform path (``ops/filter.py:fftfilt_device``); the
ZERO-INPUT response is linear in the block's entry state ``z`` via the
observability matrix, a batched (L, k) matmul.  The only sequential work
left is the carry ``z_{j+1} = F^L z_j + G x_block_j`` — an
``n/L``-step scan of k-vectors (k = filter order), ~3 orders of
magnitude shorter than the naive scan.  All recurrence precomputes
(impulse response, observability, input-to-state kernels, F^L) are
generated on host in f64 from the transposed direct-form-II state
matrices, so the device graph is convolutions + matmuls + a short scan.

State convention: ``z`` IS scipy's transposed-DF-II ``zi`` (same F, g,
c, d matrices scipy's ``lfilter`` implements sample-by-sample), so
``zi``/``zf`` interoperate with ``scipy.signal`` exactly; verified
element-wise in ``tests/test_iir.py``.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "lfiltic",

    "lfilter",
    "lfilter_device",
    "lfilter_zi",
    "filtfilt",
    "sosfilt",
    "sosfilt_zi",
    "sosfiltfilt",
]

_BLOCK = 1024  # block length L: >= 8x typical orders, one fused-size conv


def _normalize_ba(b, a):
    """Pad b, a to equal length and normalize a[0] = 1 (f64)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if b.ndim != 1 or a.ndim != 1 or b.size == 0 or a.size == 0:
        raise ValueError("b and a must be non-empty 1-D coefficient arrays")
    if a[0] == 0.0:
        raise ValueError("a[0] must be nonzero")
    m = max(b.shape[0], a.shape[0])
    b = np.pad(b, (0, m - b.shape[0])) / a[0]
    a = np.pad(a, (0, m - a.shape[0])) / a[0]
    return b, a


def _df2t_matrices(b: np.ndarray, a: np.ndarray):
    """Transposed direct-form-II state space (f64): z_t = F z_{t-1} + g x_t,
    y_t = c^T z_{t-1} + d x_t, with k = len(a) - 1 states."""
    k = a.shape[0] - 1
    f = np.zeros((k, k), dtype=np.float64)
    f[:, 0] = -a[1:]
    f[: k - 1, 1:] = np.eye(k - 1)
    g = b[1:] - a[1:] * b[0]
    c = np.zeros(k, dtype=np.float64)
    if k:
        c[0] = 1.0
    return f, g, c, float(b[0])


@functools.lru_cache(maxsize=None)
def _block_tables(bk: tuple, ak: tuple, L: int, rem: int):
    """Host-precomputed block-state tables (f64 -> f32):

    ``h``   (L,)   impulse response of b/a (zero-state in-block kernel)
    ``obs`` (L, k) zero-input response rows: obs[t] = c^T F^t
    ``gin`` (L, k) input-to-end-state kernel: gin[j] = (F^{L-1-j} g)^T
    ``fl``  (k, k) F^L (block carry propagator)
    ``gr``  (rem, k), ``fr`` (k, k): same for the trailing partial block
    (state at sample n, so ``zf`` is exact for any n).
    """
    b = np.asarray(bk, dtype=np.float64)
    a = np.asarray(ak, dtype=np.float64)
    f, g, c, d = _df2t_matrices(b, a)
    k = f.shape[0]
    # Impulse response by running the recursion L steps in f64.
    h = np.empty(L, dtype=np.float64)
    z = np.zeros(k, dtype=np.float64)
    x = 1.0
    for t in range(L):
        h[t] = (c @ z if k else 0.0) + d * x
        z = f @ z + g * x if k else z
        x = 0.0
    # Observability rows and input kernels by iterating F.
    obs = np.empty((L, k), dtype=np.float64)
    powg = np.empty((L, k), dtype=np.float64)  # powg[i] = F^i g
    row = c.copy()
    col = g.copy()
    for t in range(L):
        obs[t] = row
        powg[t] = col
        row = f.T @ row
        col = f @ col
    fl = np.linalg.matrix_power(f, L) if k else f
    gin = powg[::-1].copy()  # gin[j] = F^{L-1-j} g
    gr = powg[:rem][::-1].copy() if rem else np.zeros((0, k))
    fr = np.linalg.matrix_power(f, rem) if k else f
    f32 = np.float32
    return (
        h.astype(f32),
        obs.astype(f32),
        gin.astype(f32),
        fl.astype(f32),
        gr.astype(f32),
        fr.astype(f32),
    )


def lfilter_device(b, a, x, zi=None, block: int = _BLOCK):
    """Filter (R, n) f32 rows with the rational filter b/a on device.

    jit-composable (b, a are trace-time constants).  Returns ``y`` when
    ``zi`` is None, else ``(y, zf)`` with scipy's transposed-DF-II state
    convention (``zi``/``zf``: (R, k) rows).
    """
    import jax.numpy as jnp
    from jax import lax

    from .filter import fftfilt_device

    b64, a64 = _normalize_ba(b, a)
    k = b64.shape[0] - 1
    x = jnp.asarray(x, dtype=jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    if x.ndim != 2 or x.shape[-1] < 1:
        raise ValueError(f"lfilter expects (n,) or (R, n) input, got shape {x.shape}")
    r, n = x.shape
    if k == 0:
        y = jnp.float32(b64[0]) * x
        out = y[0] if squeeze else y
        if zi is None:
            return out
        zf = jnp.zeros((r, 0), jnp.float32)
        return out, (zf[0] if squeeze else zf)
    L = max(4 * k, min(block, max(16, n)))
    nb = -(-n // L)
    rem = n - (nb - 1) * L  # 1..L samples in the last block
    h, obs, gin, fl, gr, fr = _block_tables(tuple(b64), tuple(a64), L, rem % L)
    pad = nb * L - n
    xp = jnp.pad(x, ((0, 0), (0, pad))) if pad else x
    blocks = xp.reshape(r * nb, L)
    # State/recombination matmuls are tiny (k <= tens) but ERROR-CRITICAL —
    # every block's output rides them, so they run at HIGHEST regardless of
    # the precision mode (a reduced-precision dot gives ~1e-2 state error
    # at n=2^16).
    hi = lax.Precision.HIGHEST
    # Zero-state response: one batched causal FIR conv over all blocks.
    y_zs = fftfilt_device(blocks, h).reshape(r, nb, L)
    # Input-to-end-state of each block: (r*nb, L) @ (L, k) matmul.
    z_end_zs = jnp.dot(blocks, jnp.asarray(gin), precision=hi).reshape(r, nb, k)
    z0 = (
        jnp.zeros((r, k), jnp.float32)
        if zi is None
        else jnp.broadcast_to(jnp.asarray(zi, dtype=jnp.float32), (r, k))
    )
    flT = jnp.asarray(fl).T

    def step(z, zend):
        return zend + jnp.dot(z, flT, precision=hi), z

    z_last, z_starts = lax.scan(step, z0, jnp.moveaxis(z_end_zs, 1, 0))
    z_starts = jnp.moveaxis(z_starts, 0, 1)  # (r, nb, k): entry state per block
    y = y_zs + jnp.einsum("rjk,lk->rjl", z_starts, jnp.asarray(obs), precision=hi)
    y = y.reshape(r, nb * L)[:, :n]
    out = y[0] if squeeze else y
    if zi is None:
        return out
    # Exact state at sample n: propagate the LAST block's entry state by
    # the rem-step tables (the zero-padded tail never touches zf).
    z_sl = z_starts[:, -1]
    if rem == L:
        zf = z_last
    else:
        tail = xp.reshape(r, nb, L)[:, -1, :rem]
        zf = jnp.dot(z_sl, jnp.asarray(fr).T, precision=hi) + jnp.dot(
            tail, jnp.asarray(gr), precision=hi
        )
    return out, (zf[0] if squeeze else zf)


def lfilter(b, a, x, axis: int = -1, zi=None):
    """``scipy.signal.lfilter``: rational IIR/FIR filter along ``axis``.

    NumPy in/out; returns ``y``, or ``(y, zf)`` when ``zi`` is given
    (scipy's transposed-DF-II state, shape = x.shape with ``axis``
    replaced by ``max(len(a), len(b)) - 1``).
    """
    x = np.asarray(x, dtype=np.float64)
    moved = np.moveaxis(x, axis, -1)
    lead = moved.shape[:-1]
    rows = moved.reshape(-1, moved.shape[-1]).astype(np.float32)
    zrows = None
    if zi is not None:
        zi = np.asarray(zi, dtype=np.float32)
        k = max(np.atleast_1d(b).shape[0], np.atleast_1d(a).shape[0]) - 1
        if zi.ndim == 1:
            zrows = np.broadcast_to(zi, (rows.shape[0], k))
        else:
            zrows = np.moveaxis(zi, axis, -1).reshape(-1, k)
    res = lfilter_device(b, a, rows, zi=zrows)
    if zi is None:
        y = np.asarray(res)
        return np.moveaxis(y.reshape(*lead, -1), -1, axis)
    y, zf = (np.asarray(v) for v in res)
    y = np.moveaxis(y.reshape(*lead, -1), -1, axis)
    zf = np.moveaxis(zf.reshape(*lead, -1), -1, axis)
    return y, zf


def lfilter_zi(b, a) -> np.ndarray:
    """``scipy.signal.lfilter_zi``: the steady-state DF2T state for a unit
    step — ``zi = (I - F)^-1 g`` (f64 host solve)."""
    b64, a64 = _normalize_ba(b, a)
    f, g, _, _ = _df2t_matrices(b64, a64)
    k = f.shape[0]
    if k == 0:
        return np.zeros(0, dtype=np.float64)
    return np.linalg.solve(np.eye(k) - f, g)


def filtfilt(b, a, x, axis: int = -1, padtype: str | None = "odd", padlen: int | None = None):
    """``scipy.signal.filtfilt`` (pad method): zero-phase IIR filtering —
    odd/even/constant edge extension, steady-state initial conditions,
    forward and reverse passes through :func:`lfilter`."""
    x = np.asarray(x, dtype=np.float64)
    m = max(np.atleast_1d(b).shape[0], np.atleast_1d(a).shape[0])
    if padtype not in ("odd", "even", "constant", None):
        raise ValueError(f"padtype must be odd|even|constant|None, got {padtype!r}")
    pad = 0 if padtype is None else (3 * m if padlen is None else int(padlen))
    n = x.shape[axis]
    if pad >= n:
        raise ValueError(f"padlen ({pad}) must be less than x.shape[axis] ({n})")
    moved = np.moveaxis(x, axis, -1)
    if pad > 0:
        head, tail = moved[..., pad:0:-1], moved[..., -2 : -pad - 2 : -1]
        if padtype == "odd":
            head = 2.0 * moved[..., :1] - head
            tail = 2.0 * moved[..., -1:] - tail
        elif padtype == "constant":
            head = np.broadcast_to(moved[..., :1], head.shape)
            tail = np.broadcast_to(moved[..., -1:], tail.shape)
        ext = np.concatenate([head, moved, tail], axis=-1)
    else:
        ext = moved
    zi = lfilter_zi(b, a)
    y, _ = lfilter(b, a, ext, axis=-1, zi=zi * ext[..., :1])
    y = y[..., ::-1]
    y, _ = lfilter(b, a, y, axis=-1, zi=zi * y[..., :1])
    y = y[..., ::-1]
    if pad > 0:
        y = y[..., pad:-pad]
    return np.moveaxis(y, -1, axis)


def sosfilt(sos, x, axis: int = -1, zi=None):
    """``scipy.signal.sosfilt``: cascade of second-order sections, each
    section through the block-state engine.  ``zi``: (n_sections, ..., 2)
    like scipy; returns ``(y, zf)`` when given."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    y = np.asarray(x, dtype=np.float64)
    zfs = []
    for i in range(sos.shape[0]):
        b, a = sos[i, :3], sos[i, 3:]
        if zi is None:
            y = lfilter(b, a, y, axis=axis)
        else:
            y, zf = lfilter(b, a, y, axis=axis, zi=np.asarray(zi)[i])
            zfs.append(zf)
    if zi is None:
        return y
    return y, np.stack(zfs)


def sosfilt_zi(sos) -> np.ndarray:
    """``scipy.signal.sosfilt_zi``: per-section steady-state states for a
    unit step, each scaled by the DC gain of the sections before it."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    zi = np.empty((sos.shape[0], 2), dtype=np.float64)
    scale = 1.0
    for i in range(sos.shape[0]):
        b, a = sos[i, :3], sos[i, 3:]
        zi[i] = scale * lfilter_zi(b, a)
        scale *= b.sum() / a.sum()
    return zi


def sosfiltfilt(sos, x, axis: int = -1, padtype: str | None = "odd", padlen: int | None = None):
    """``scipy.signal.sosfiltfilt``: zero-phase second-order-section
    filtering — the pad method of :func:`filtfilt` with per-section
    steady-state initial conditions, both passes through the block-state
    engine."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    x = np.asarray(x, dtype=np.float64)
    if padtype not in ("odd", "even", "constant", None):
        raise ValueError(f"padtype must be odd|even|constant|None, got {padtype!r}")
    # scipy's default padlen: 3 * the effective tap count of the cascade.
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    pad = 0 if padtype is None else (3 * ntaps if padlen is None else int(padlen))
    n = x.shape[axis]
    if pad >= n:
        raise ValueError(f"padlen ({pad}) must be less than x.shape[axis] ({n})")
    moved = np.moveaxis(x, axis, -1)
    if pad > 0:
        head, tail = moved[..., pad:0:-1], moved[..., -2 : -pad - 2 : -1]
        if padtype == "odd":
            head = 2.0 * moved[..., :1] - head
            tail = 2.0 * moved[..., -1:] - tail
        elif padtype == "constant":
            head = np.broadcast_to(moved[..., :1], head.shape)
            tail = np.broadcast_to(moved[..., -1:], tail.shape)
        ext = np.concatenate([head, moved, tail], axis=-1)
    else:
        ext = moved
    zi = sosfilt_zi(sos)  # (m, 2)
    # Broadcast to (m, ...lead, 2) scaled by each row's first sample.
    zi_shaped = zi.reshape((sos.shape[0],) + (1,) * (ext.ndim - 1) + (2,))
    y, _ = sosfilt(sos, ext, axis=-1, zi=zi_shaped * ext[..., :1])
    y = y[..., ::-1]
    y, _ = sosfilt(sos, y, axis=-1, zi=zi_shaped * y[..., :1])
    y = y[..., ::-1]
    if pad > 0:
        y = y[..., pad:-pad]
    return np.moveaxis(y, -1, axis)


def lfiltic(b, a, y, x=None) -> np.ndarray:
    """Initial ``lfilter`` state from past outputs/inputs
    (``scipy.signal.lfiltic``): the transposed direct-form-II delay line
    that makes ``lfilter(b, a, x_future, zi=...)`` continue the sequence
    whose most recent outputs were ``y[0], y[1], ...`` (newest first) and
    inputs ``x[0], x[1], ...``."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a[0] != 1.0:
        if a[0] == 0.0:
            raise ValueError("a[0] must be nonzero")
        b, a = b / a[0], a / a[0]
    n, m = a.size - 1, b.size - 1
    k = max(n, m)
    y = np.asarray(y, dtype=np.float64)[:n]
    y = np.concatenate([y, np.zeros(n - y.size)])
    if x is None:
        x = np.zeros(m)
    else:
        x = np.asarray(x, dtype=np.float64)[:m]
        x = np.concatenate([x, np.zeros(m - x.size)])
    zi = np.zeros(k, dtype=np.float64)
    for i in range(m):
        zi[i] += np.sum(b[i + 1:] * x[: m - i])
    for i in range(n):
        zi[i] -= np.sum(a[i + 1:] * y[: n - i])
    return zi
