"""PALLAS backend: jitted device pipelines over the library's own engine.

The backend keeps its name, but no Pallas kernel remains on its path: every
stage is plain jnp/lax (kernels/fused_jnp.py, kernels/large.py) that XLA
compiles for the device.

Plays the role of the reference's transform orchestrators
(``src/fft.rs:39-133``, ``src/ifft.rs:39-150``), but where the reference
queues 1-4 kernel dispatches per call from the host, here the whole pipeline
(plan lookup, kernel dispatch, inverse normalization) traces into ONE jitted
XLA program per (shape, direction) — the device boundary is crossed exactly
once in and once out, like the reference's single upload/readback pair
(``src/fft.rs:61-63,129-131``).
"""

from __future__ import annotations

import functools

import jax

from ..kernels.large import transform_any

__all__ = ["forward", "inverse"]


@functools.partial(jax.jit, static_argnums=(1,))
def _forward_real(x, n: int):
    return transform_any(x, None, n, -1)


@functools.partial(jax.jit, static_argnums=(2,))
def _inverse(xr, xi, n: int):
    # 1/N normalization folded into the last matmul's table at fused sizes
    # (zero extra HBM passes; measured ~4 us at B=64 n=4,096) — the analog
    # of the reference's CPU-side divide (``src/ifft.rs:140-146``).
    return transform_any(xr, xi, n, +1, scale=1.0 / n)


def forward(x):
    """(B, n) real f32 -> split-complex spectrum ((B, n), (B, n))."""
    return _forward_real(x, x.shape[-1])


def inverse(xr, xi):
    """(B, n) split-complex spectrum -> normalized split-complex signal."""
    return _inverse(xr, xi, xr.shape[-1])
