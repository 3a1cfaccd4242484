"""Pencil-decomposed 2-D FFT: one image too large for a chip, rows sharded.

The standard distributed layout for big 2-D (and, by axis batching, 3-D)
transforms: the (H, W) image lives ROW-sharded over the mesh axis, so

  1. each device transforms its own rows (length-W FFTs, all local),
  2. one ``lax.all_to_all`` re-shards to a COLUMN-sharded "pencil"
     (the distributed transpose — the only communication),
  3. each device transforms its own columns (length-H FFTs, local),
  4. a second ``all_to_all`` restores the row-sharded layout.

Each local pass reuses the single-chip measured dispatch (the same
``transform_any`` the 1-D paths run), so this is a thin composition over
the fast path, like ``distributed.py``'s 1-D four-step.  Communication
volume is 2 * H * W * 8 bytes / device pass, independent of the mesh size.

Extension beyond the reference (it has no distributed anything); the
pencil pattern itself is the classic one (e.g. P3DFFT / heFFTe and the
scaling-book transpose recipe), realized here with shard_map + tiled
all_to_all instead of MPI.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..kernels.large import transform_any

__all__ = ["fft2_sharded", "ifft2_sharded", "fftn_sharded", "ifftn_sharded"]


def _check_dims(h: int, w: int, d: int) -> None:
    for name, n in (("H", h), ("W", w)):
        if n < 2 or n & (n - 1):
            raise ValueError(f"fft2_sharded requires power-of-two {name}, got {n}")
    if h % d or w % d:
        raise ValueError(
            f"fft2_sharded requires the mesh axis size {d} to divide both "
            f"H={h} and W={w}"
        )
    if h // d < 1 or w // d < 1:
        raise ValueError(f"image {h}x{w} too small for a {d}-device pencil split")


def _pencil(xr, xi, h: int, w: int, sign: int, mesh: Mesh, sp: str, dp):
    """Core sharded pipeline over (B, H, W) global arrays (xi may be None)."""

    def local(lr, li):
        bl, hd, _ = lr.shape  # (B_local, H/d, W)
        # 1. Row FFTs (length W), all rows of this shard folded into one call.
        rr, ri = transform_any(lr.reshape(bl * hd, w), None if li is None else li.reshape(bl * hd, w), w, sign)
        rr = rr.reshape(bl, hd, w)
        ri = ri.reshape(bl, hd, w)
        # 2. Distributed transpose: (B, H/d, W) -> (B, H, W/d).  tiled
        #    all_to_all splits the column axis d ways and concatenates the
        #    received row blocks in peer order = global row order.
        rr = lax.all_to_all(rr, sp, split_axis=2, concat_axis=1, tiled=True)
        ri = lax.all_to_all(ri, sp, split_axis=2, concat_axis=1, tiled=True)
        # 3. Column FFTs (length H): make H minor, fold, transform, restore.
        wd = rr.shape[2]
        cr = jnp.swapaxes(rr, 1, 2).reshape(bl * wd, h)
        ci = jnp.swapaxes(ri, 1, 2).reshape(bl * wd, h)
        cr, ci = transform_any(cr, ci, h, sign)
        cr = jnp.swapaxes(cr.reshape(bl, wd, h), 1, 2)
        ci = jnp.swapaxes(ci.reshape(bl, wd, h), 1, 2)
        # 4. Transpose back to the row-sharded layout: (B, H, W/d) -> (B, H/d, W).
        cr = lax.all_to_all(cr, sp, split_axis=1, concat_axis=2, tiled=True)
        ci = lax.all_to_all(ci, sp, split_axis=1, concat_axis=2, tiled=True)
        return cr, ci

    spec = P(dp, sp, None)
    yr, yi = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, None if xi is None else spec),
        out_specs=(spec, spec),
        check_vma=False,
    )(xr, xi)
    return yr, yi


def _run2d(xr, xi, mesh: Mesh, sign: int, sp: str, dp):
    squeeze = xr.ndim == 2
    if squeeze:
        xr = xr[None]
        xi = None if xi is None else xi[None]
    if xr.ndim != 3:
        raise ValueError(f"fft2_sharded expects (H, W) or (B, H, W), got {xr.shape}")
    b, h, w = xr.shape
    d = mesh.shape[sp]
    _check_dims(h, w, d)
    if dp is not None and b % mesh.shape[dp]:
        raise ValueError(
            f"batch {b} not divisible by mesh axis '{dp}' size {mesh.shape[dp]}"
        )
    yr, yi = _pencil(xr, xi, h, w, sign, mesh, sp, dp)
    return (yr[0], yi[0]) if squeeze else (yr, yi)


def fft2_sharded(x, mesh: Mesh, sp_axis: str = "sp", dp_axis: str | None = None, imag=None):
    """2-D FFT of a single large image with its ROWS sharded over the mesh.

    ``x``: (H, W) or (B, H, W) f32, power-of-two H and W both divisible by
    the ``sp_axis`` size; ``imag`` optionally supplies a complex input's
    imaginary part.  Optional ``dp_axis`` additionally shards the batch.
    Returns split-complex global arrays, row-sharded, natural order —
    ``numpy.fft.fft2`` semantics.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    xi = None if imag is None else jnp.asarray(imag, dtype=jnp.float32)
    if xi is not None and xi.shape != x.shape:
        raise ValueError(f"fft2_sharded: real and imag shapes differ: {x.shape} vs {xi.shape}")
    return _run2d(x, xi, mesh, -1, sp_axis, dp_axis)


def ifft2_sharded(xr, xi, mesh: Mesh, sp_axis: str = "sp", dp_axis: str | None = None):
    """Inverse 2-D FFT (1/(H*W) normalized) of a row-sharded split-complex
    image — the inverse of :func:`fft2_sharded`."""
    xr = jnp.asarray(xr, dtype=jnp.float32)
    xi = jnp.asarray(xi, dtype=jnp.float32)
    if xr.shape != xi.shape:
        raise ValueError(f"ifft2_sharded: shapes differ: {xr.shape} vs {xi.shape}")
    yr, yi = _run2d(xr, xi, mesh, +1, sp_axis, dp_axis)
    s = jnp.float32(1.0 / (xr.shape[-1] * xr.shape[-2]))
    return yr * s, yi * s


# ── 3-D volumes: slab decomposition ──────────────────────────────────────────


def _slab(xr, xi, d0: int, h: int, w: int, sign: int, mesh: Mesh, sp: str):
    """Core pipeline over (D, H, W) global arrays sharded on D (xi may be
    None).  Each device holds complete (H, W) planes, so two of the three
    passes are entirely local; only the D-axis pass needs the all_to_all."""

    def local(lr, li):
        dd, _, _ = lr.shape  # (D/d, H, W)
        # 1. W-axis FFTs: every plane row local.
        rr, ri = transform_any(
            lr.reshape(dd * h, w), None if li is None else li.reshape(dd * h, w), w, sign
        )
        rr = rr.reshape(dd, h, w)
        ri = ri.reshape(dd, h, w)
        # 2. H-axis FFTs: make H minor, fold, transform, restore.
        cr = jnp.swapaxes(rr, 1, 2).reshape(dd * w, h)
        ci = jnp.swapaxes(ri, 1, 2).reshape(dd * w, h)
        cr, ci = transform_any(cr, ci, h, sign)
        rr = jnp.swapaxes(cr.reshape(dd, w, h), 1, 2)
        ri = jnp.swapaxes(ci.reshape(dd, w, h), 1, 2)
        # 3. D-axis FFTs: reshard (D/d, H, W) -> (D, H/d, W), transform the
        #    now-local D axis, reshard back.
        rr = lax.all_to_all(rr, sp, split_axis=1, concat_axis=0, tiled=True)
        ri = lax.all_to_all(ri, sp, split_axis=1, concat_axis=0, tiled=True)
        hd = rr.shape[1]
        dr = jnp.moveaxis(rr, 0, 2).reshape(hd * w, d0)
        di = jnp.moveaxis(ri, 0, 2).reshape(hd * w, d0)
        dr, di = transform_any(dr, di, d0, sign)
        rr = jnp.moveaxis(dr.reshape(hd, w, d0), 2, 0)
        ri = jnp.moveaxis(di.reshape(hd, w, d0), 2, 0)
        rr = lax.all_to_all(rr, sp, split_axis=0, concat_axis=1, tiled=True)
        ri = lax.all_to_all(ri, sp, split_axis=0, concat_axis=1, tiled=True)
        return rr, ri

    spec = P(sp, None, None)
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, None if xi is None else spec),
        out_specs=(spec, spec),
        check_vma=False,
    )(xr, xi)


def fftn_sharded(x, mesh: Mesh, sp_axis: str = "sp", imag=None):
    """3-D FFT of a volume with its LEADING axis sharded (slab decomposition).

    ``x``: (D, H, W) f32, power-of-two dims, D and H divisible by the mesh
    axis size.  The in-plane (H, W) passes are entirely local; the D-axis
    pass reshards with one tiled ``all_to_all`` each way.  Returns
    split-complex global arrays, D-sharded, natural order —
    ``numpy.fft.fftn`` semantics over all three axes.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    xi = None if imag is None else jnp.asarray(imag, dtype=jnp.float32)
    if x.ndim != 3:
        raise ValueError(f"fftn_sharded expects a (D, H, W) volume, got {x.shape}")
    if xi is not None and xi.shape != x.shape:
        raise ValueError(f"fftn_sharded: real and imag shapes differ: {x.shape} vs {xi.shape}")
    d0, h, w = x.shape
    d = mesh.shape[sp_axis]
    _check_dims(h, w, d)
    if d0 < 2 or d0 & (d0 - 1):
        raise ValueError(f"fftn_sharded requires power-of-two D, got {d0}")
    if d0 % d or h % d:
        raise ValueError(
            f"fftn_sharded requires the mesh axis size {d} to divide D={d0} and H={h}"
        )
    return _slab(x, xi, d0, h, w, -1, mesh, sp_axis)


def ifftn_sharded(xr, xi, mesh: Mesh, sp_axis: str = "sp"):
    """Inverse 3-D FFT (1/(D*H*W) normalized) of a D-sharded split-complex
    volume — the inverse of :func:`fftn_sharded`."""
    xr = jnp.asarray(xr, dtype=jnp.float32)
    xi = jnp.asarray(xi, dtype=jnp.float32)
    if xr.shape != xi.shape:
        raise ValueError(f"ifftn_sharded: shapes differ: {xr.shape} vs {xi.shape}")
    if xr.ndim != 3:
        raise ValueError(f"ifftn_sharded expects a (D, H, W) volume, got {xr.shape}")
    d0, h, w = xr.shape
    d = mesh.shape[sp_axis]
    _check_dims(h, w, d)
    if d0 < 2 or d0 & (d0 - 1) or d0 % d or h % d:
        raise ValueError(
            f"ifftn_sharded requires power-of-two dims with {d} | D and {d} | H, "
            f"got {xr.shape}"
        )
    yr, yi = _slab(xr, xi, d0, h, w, +1, mesh, sp_axis)
    s = jnp.float32(1.0 / (d0 * h * w))
    return yr * s, yi * s
