"""Batch sharding over the device mesh (the "data-parallel" axis).

The reference packs B signals into one flat buffer so a single dispatch
covers the whole batch (``src/fft.rs:191-205``).  Across chips the same idea
is a ``shard_map`` over the batch dimension: each device runs the fused
kernels on its rows, no collective traffic at all — batch FFT is
embarrassingly parallel, so the shard-map body is exactly the single-chip
transform.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..kernels.large import transform_any

__all__ = [
    "default_mesh",
    "fft_batch_sharded",
    "ifft_batch_sharded",
    "fft2_batch_sharded",
    "welch_sharded",
    "oaconvolve_sharded",
    "lfilter_sharded",
]


def default_mesh(axis_name: str = "dp", devices=None) -> Mesh:
    """A 1-D mesh over all (or the given) devices."""
    import numpy as np

    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)


def fft_batch_sharded(x, mesh: Mesh, axis_name: str = "dp"):
    """Forward FFT of (B, n) with B sharded over ``axis_name``.

    B must divide evenly by the mesh axis size.  Returns split-complex
    (re, im) with the same sharding.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    b, n = x.shape
    d = mesh.shape[axis_name]
    if b % d:
        raise ValueError(f"batch {b} not divisible by mesh axis '{axis_name}' size {d}")

    def local(xl):
        return transform_any(xl, None, n, -1)

    spec = P(axis_name, None)
    return _shard_map(local, mesh, (spec,), (spec, spec))(x)


def fft2_batch_sharded(x, mesh: Mesh, axis_name: str = "dp"):
    """Forward 2-D FFT of a (B, H, W) image batch with B sharded over the
    mesh — each device transforms its images locally, zero collectives.

    B must divide evenly by the mesh axis size.  Returns split-complex
    (re, im) with the same sharding.  Sides follow the fft2 contract (any
    length >= 2; non-pow2 sides run via Bluestein).
    """
    from ..ops.fft2d import _check_sides, _transform2d

    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim != 3:
        raise ValueError(f"fft2_batch_sharded expects (B, H, W), got {x.shape}")
    b = x.shape[0]
    _check_sides(x.shape[1], x.shape[2])
    d = mesh.shape[axis_name]
    if b % d:
        raise ValueError(f"batch {b} not divisible by mesh axis '{axis_name}' size {d}")

    def local(xl):
        return _transform2d(xl, None, -1)

    spec = P(axis_name, None, None)
    return _shard_map(local, mesh, (spec,), (spec, spec))(x)


def welch_sharded(
    x,
    mesh: Mesh,
    axis_name: str = "dp",
    fs: float = 1.0,
    window: str | None = "hann",
    nperseg: int = 256,
    noverlap: int | None = None,
    detrend: bool | str = True,
    scaling: str = "density",
):
    """Welch PSD of a long signal with the SEGMENTS sharded over the mesh.

    The segment axis is this estimator's batch dimension: each device
    windows and transforms its own slice of segments and reduces its partial
    power sum; one ``psum`` over ``axis_name`` completes the average — the
    collective-reduction pattern (vs the zero-comms batch sharding and the
    all-to-all distributed transform).  Semantics identical to
    :func:`gpu_fft_tpu.welch_device` for ANY segment count: when the count
    does not divide the mesh, the segment axis is padded with zero rows and
    the padding is masked out of the power sum, so sharded and single-chip
    Welch agree element-wise.

    Returns ``(freqs, psd)`` — psd replicated across devices.
    """
    import numpy as np

    from ..ops.spectral import _welch_scale_mult
    from ..ops.stft import window_table

    if scaling not in ("density", "spectrum"):
        raise ValueError(f"scaling must be 'density' or 'spectrum', got {scaling!r}")
    if nperseg < 2 or nperseg & (nperseg - 1):
        raise ValueError(f"nperseg must be a power of two >= 2, got {nperseg}")
    noverlap = nperseg // 2 if noverlap is None else noverlap
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"noverlap must be in [0, nperseg), got {noverlap}")
    hop = nperseg - noverlap
    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim != 1:
        raise ValueError(f"welch_sharded expects a 1-D signal, got shape {x.shape}")
    d = mesh.shape[axis_name]
    num_seg = (x.shape[0] - nperseg) // hop + 1
    if num_seg < 1:
        raise ValueError(
            f"signal of {x.shape[0]} samples is shorter than one {nperseg} segment"
        )
    from ..ops.stft import frame_signal

    # Pad the segment axis up to a mesh multiple with zero rows (framed out
    # of a zero-extended signal); the padding is masked out of the power sum
    # below, so the estimate equals single-chip Welch for any count.
    num_pad = -(-num_seg // d) * d
    need = (num_pad - 1) * hop + nperseg
    if need > x.shape[0]:
        x = jnp.pad(x, (0, need - x.shape[0]))
    segs = frame_signal(x, nperseg, hop, num_pad)  # sharded over rows below
    w = window_table(window, nperseg)
    rows = num_pad // d

    def local(sl):
        from ..ops.spectral import _detrend_rows

        sl = _detrend_rows(sl, detrend)
        yr, yi = transform_any(sl * w[None], None, nperseg, -1)
        h = nperseg // 2 + 1
        gidx = jax.lax.axis_index(axis_name) * rows + jnp.arange(rows)
        mask = (gidx < num_seg).astype(jnp.float32)
        part = jnp.sum((yr[:, :h] ** 2 + yi[:, :h] ** 2) * mask[:, None], axis=0)
        return jax.lax.psum(part, axis_name) * jnp.float32(1.0 / num_seg)

    power = _shard_map(local, mesh, (P(axis_name, None),), P())(segs)
    freqs = np.arange(nperseg // 2 + 1, dtype=np.float64) * (fs / nperseg)
    return freqs, power * _welch_scale_mult(window, nperseg, fs, scaling)


def oaconvolve_sharded(x, h, mesh: Mesh, axis_name: str = "dp"):
    """FIR convolution of a LONG signal with the signal sharded over the mesh.

    The overlap-add identity distributes: cut ``x`` into one contiguous
    chunk per device, convolve each chunk locally (through
    :func:`gpu_fft_tpu.oaconvolve_device`'s batched block path), and the
    only cross-chip dependency is each chunk's length-(lh-1) convolution
    tail, which belongs at the head of the NEXT device's span — one
    ``lax.ppermute`` neighbor exchange.  This is the library's
    point-to-point collective pattern (vs zero-comms batch sharding, the
    all-to-all distributed transform, and the psum Welch reduction).

    ``x``: (n,) real f32; ``h``: (lh,) taps with 2 <= lh <= n/d + 1.
    Returns the full (n + lh - 1,) linear convolution.
    """
    from ..ops.filter import oaconvolve_device

    x = jnp.asarray(x, dtype=jnp.float32)
    h = jnp.asarray(h, dtype=jnp.float32)
    if x.ndim != 1 or h.ndim != 1:
        raise ValueError(
            f"oaconvolve_sharded expects 1-D signal and taps, got {x.shape} vs {h.shape}"
        )
    n, lh = x.shape[0], h.shape[0]
    d = mesh.shape[axis_name]
    if lh < 2:
        raise ValueError(f"oaconvolve_sharded needs len(h) >= 2, got {lh}")
    chunk = -(-n // d)
    if lh - 1 > chunk:
        raise ValueError(
            f"taps ({lh}) must fit one device's chunk ({chunk}); "
            "use fewer devices or the single-chip oaconvolve"
        )
    xp = jnp.pad(x, (0, d * chunk - n))
    t = lh - 1
    last = d - 1

    def local(xl):
        full = oaconvolve_device(xl, h)  # (1, chunk + t)
        main, tail = full[:, :chunk], full[:, chunk:]
        # Tail of device i belongs at the head of device i+1's span.
        recv = jax.lax.ppermute(tail, axis_name, [(i, i + 1) for i in range(last)])
        main = main.at[:, :t].add(recv)
        # Only the LAST device's tail survives as the global convolution tail.
        idx = jax.lax.axis_index(axis_name)
        gtail = jax.lax.psum(jnp.where(idx == last, tail, 0.0), axis_name)
        return main, gtail

    main, gtail = _shard_map(
        local, mesh, (P(axis_name),), (P(axis_name), P(None, None))
    )(xp.reshape(d, chunk))
    return jnp.concatenate([main.reshape(-1), gtail[0]])[: n + lh - 1]


def ifft_batch_sharded(xr, xi, mesh: Mesh, axis_name: str = "dp"):
    """Inverse FFT of a (B, n) split-complex batch sharded over ``axis_name``."""
    xr = jnp.asarray(xr, dtype=jnp.float32)
    xi = jnp.asarray(xi, dtype=jnp.float32)
    b, n = xr.shape
    d = mesh.shape[axis_name]
    if b % d:
        raise ValueError(f"batch {b} not divisible by mesh axis '{axis_name}' size {d}")

    def local(r, i):
        return transform_any(r, i, n, +1, scale=1.0 / n)

    spec = P(axis_name, None)
    return _shard_map(local, mesh, (spec, spec), (spec, spec))(xr, xi)


def lfilter_sharded(b, a, x, mesh: Mesh, axis_name: str = "sp"):
    """Sequence-parallel IIR filtering: the signal sharded over the mesh.

    The block-state decomposition (``ops/iir.py``) distributes across
    chips exactly as it does across blocks: each device runs the
    zero-entry-state filter on its contiguous shard (one call into the
    measured ``lfilter_device``, whose ``zf`` IS the shard's
    input-to-state contribution), one tiny ``all_gather`` of the (d, k)
    state vectors crosses devices, every device composes the affine carry
    prefix with host-precomputed propagator powers F^(m*p) (k x k, f64-
    generated), and a shard-local observability matmul adds the
    zero-input response.  Per-call traffic is d*k floats — INDEPENDENT
    of signal length — the sequential-dependency analog of
    :func:`oaconvolve_sharded`'s tail exchange.

    ``x``: (n,) real f32 with d | n; returns the (n,) filtered signal.
    """
    import numpy as np

    from ..ops.iir import _block_tables, _df2t_matrices, _normalize_ba, lfilter_device

    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim != 1:
        raise ValueError(f"lfilter_sharded expects a 1-D signal, got shape {x.shape}")
    b64, a64 = _normalize_ba(b, a)
    k = b64.shape[0] - 1
    d = mesh.shape[axis_name]
    n = x.shape[0]
    if n % d:
        raise ValueError(f"signal length {n} must divide over {d} devices")
    m = n // d
    if k == 0:
        spec = P(axis_name)
        return _shard_map(lambda xl: jnp.float32(b64[0]) * xl, mesh, (spec,), spec)(x)
    # Host f64 precomputes: the shard observability obs[t] = c^T F^t
    # (t < m) and the masked propagator tensor M[i, j] = F^(m*(i-1-j)) for
    # j < i (zero otherwise), so z_entry = einsum('ijkl,jl->ik', M, zetas).
    f, g, c, dd = _df2t_matrices(b64, a64)
    obs = np.empty((m, k), dtype=np.float64)
    row = c.copy()
    for t in range(m):
        obs[t] = row
        row = f.T @ row
    fm = np.linalg.matrix_power(f, m)
    powers = [np.eye(k)]
    for _ in range(d - 1):
        powers.append(fm @ powers[-1])
    mask = np.zeros((d, d, k, k), dtype=np.float64)
    for i in range(d):
        for j in range(i):
            mask[i, j] = powers[i - 1 - j]
    obs32 = jnp.asarray(obs.astype(np.float32))
    mask32 = jnp.asarray(mask.astype(np.float32))
    bb = tuple(float(v) for v in b64)
    aa = tuple(float(v) for v in a64)

    def local(xl):
        y_zs, zeta = lfilter_device(bb, aa, xl, zi=jnp.zeros((1, k), jnp.float32))
        zetas = jax.lax.all_gather(zeta[0], axis_name)  # (d, k)
        entries = jnp.einsum(
            "ijkl,jl->ik", mask32, zetas, precision=jax.lax.Precision.HIGHEST
        )
        mine = jax.lax.dynamic_slice_in_dim(entries, jax.lax.axis_index(axis_name), 1, 0)
        return y_zs + jnp.dot(
            obs32, mine[0], precision=jax.lax.Precision.HIGHEST
        )[None]

    spec = P(None, axis_name)
    return _shard_map(local, mesh, (spec,), spec)(x.reshape(1, d * m))[0]
