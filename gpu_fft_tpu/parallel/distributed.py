"""Distributed single-transform FFT: four-step with an all-to-all.

One transform too large for a single device is factored n = n1 * n2 and laid
out as an (n1, n2) matrix whose COLUMNS are sharded over the mesh axis
("sp").  The classic distributed four-step then runs:

  1. local column DFTs of length n1 (each device owns whole columns),
  2. local twiddle multiply (each device holds its column slice of the
     twiddle table),
  3. ``lax.all_to_all`` re-shard: columns -> rows (the distributed
     transpose — the only communication),
  4. local row DFTs of length n2,

returning the spectrum sharded over the k1 digit.  The local DFTs reuse the
single-device transform engine, so the distributed path is a thin
composition, not a second implementation.  This is the SURVEY §2.4 planned
extension — the reference has no distributed anything to mirror.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..kernels.large import transform_any
from ..kernels.tables import twiddle_table
from ..plan import balanced_split

__all__ = ["distributed_fft", "distributed_ifft"]


def _split_for_mesh(n: int, d: int) -> tuple[int, int]:
    """Choose n = n1 * n2 with BOTH factors divisible by the mesh axis size.

    The pipeline shards columns (needs d | n2) and, after the all_to_all,
    rows (needs d | n1).  Starting from the balanced split, the exponent is
    clamped into the feasible band instead of raising — any power-of-two
    n >= d*d has a valid factorization, so only genuinely impossible sizes
    error out.
    """
    if d & (d - 1):
        raise ValueError(f"mesh axis size must be a power of two, got {d}")
    m = n.bit_length() - 1
    ld = d.bit_length() - 1
    if n & (n - 1) or m < 2 * ld:
        raise ValueError(
            f"distributed transform needs power-of-two n >= d^2 = {d * d}, got n={n}"
        )
    a = min(max(m // 2, ld), m - ld)  # balanced, clamped to d | n1 and d | n2
    n1 = 1 << a
    return n1, n // n1


def _distributed(x3r, x3i, n: int, n1: int, n2: int, sign: int, mesh: Mesh, sp: str, dp):
    """Core sharded pipeline.  x3*: (B, n1, n2) global arrays (x3i may be None)."""
    d = mesh.shape[sp]
    n2d = n2 // d
    twr, twi = twiddle_table(n2, n1, n, sign)  # [column digit, k1]
    twr = jnp.asarray(twr)
    twi = jnp.asarray(twi)

    def local(xlr, xli, tr, ti):
        bl = xlr.shape[0]
        # 1. Column DFTs: transpose so the transform dim is minor, fold rows.
        xt_r = jnp.swapaxes(xlr, 1, 2).reshape(bl * n2d, n1)
        xt_i = None if xli is None else jnp.swapaxes(xli, 1, 2).reshape(bl * n2d, n1)
        pr, pi = transform_any(xt_r, xt_i, n1, sign)
        # 2. Twiddle with this device's column slice.
        p3r = pr.reshape(bl, n2d, n1)
        p3i = pi.reshape(bl, n2d, n1)
        zr = p3r * tr[None] - p3i * ti[None]
        zi = p3r * ti[None] + p3i * tr[None]
        # 3. Distributed transpose: own whole rows (k1 blocks) instead of
        #    whole columns.  (bl, k1, n2d) -> (bl, k1/d, n2).
        qr = jnp.swapaxes(zr, 1, 2)
        qi = jnp.swapaxes(zi, 1, 2)
        qr = lax.all_to_all(qr, sp, split_axis=1, concat_axis=2, tiled=True)
        qi = lax.all_to_all(qi, sp, split_axis=1, concat_axis=2, tiled=True)
        # 4. Row DFTs of length n2.
        bl_k1 = qr.shape[0] * qr.shape[1]
        rr, ri = transform_any(qr.reshape(bl_k1, n2), qi.reshape(bl_k1, n2), n2, sign)
        return rr.reshape(qr.shape), ri.reshape(qi.shape)

    in_x = P(dp, None, sp)
    in_tw = P(sp, None)
    out = P(dp, sp, None)
    yr, yi = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(in_x, None if x3i is None else in_x, in_tw, in_tw),
        out_specs=(out, out),
        check_vma=False,
    )(x3r, x3i, twr, twi)
    return yr, yi


def _run(x_r, x_i, mesh: Mesh, sign: int, sp: str, dp):
    b, n = x_r.shape
    if n & (n - 1) or n < 4:
        raise ValueError(f"distributed transform requires power-of-two n >= 4, got {n}")
    if dp is not None and b % mesh.shape[dp]:
        raise ValueError(
            f"batch {b} not divisible by mesh axis '{dp}' size {mesh.shape[dp]}"
        )
    d = mesh.shape[sp]
    n1, n2 = _split_for_mesh(n, d)
    x3r = x_r.reshape(b, n1, n2)
    x3i = None if x_i is None else x_i.reshape(b, n1, n2)
    yr, yi = _distributed(x3r, x3i, n, n1, n2, sign, mesh, sp, dp)
    # Global digit-reversal: flat index k = k1 + n1*k2.  XLA inserts the
    # resharding collective for the cross-shard transpose.
    yr = jnp.swapaxes(yr, 1, 2).reshape(b, n)
    yi = jnp.swapaxes(yi, 1, 2).reshape(b, n)
    return yr, yi


def distributed_fft(x, mesh: Mesh, sp_axis: str = "sp", dp_axis: str | None = None):
    """Forward FFT of (B, n) rows with the TRANSFORM dimension sharded.

    ``sp_axis`` shards the transform (sequence-parallel); optional ``dp_axis``
    additionally shards the batch.  Returns split-complex (re, im) global
    arrays in natural order.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    return _run(x, None, mesh, -1, sp_axis, dp_axis)


def distributed_ifft(xr, xi, mesh: Mesh, sp_axis: str = "sp", dp_axis: str | None = None):
    """Inverse FFT (normalized) of (B, n) split-complex rows, transform dim sharded."""
    xr = jnp.asarray(xr, dtype=jnp.float32)
    xi = jnp.asarray(xi, dtype=jnp.float32)
    yr, yi = _run(xr, xi, mesh, +1, sp_axis, dp_axis)
    s = jnp.float32(1.0 / xr.shape[-1])
    return yr * s, yi * s
