"""Fourier Neural Operators riding the library's device FFT dispatch.

The reference library (eugenehp/gpu-fft) ships transforms; the workload it
serves downstream is spectral ML — so the library carries the
flagship model family that stresses every hot path at once: the FNO
(Li et al., "Fourier Neural Operator for Parametric PDEs", ICLR 2021).
One FNO block is exactly the library's matmul thesis:

    lift -> [ rfft -> truncate modes -> complex channel-mix (einsum)
              -> zero-pad -> irfft  (+) pointwise 1x1 conv ] x depth
         -> project

Everything inside the block is a batched matmul: the transforms run the
plan dispatch (``kernels/large.py`` — einsum stage A + folded stage B at
staged sizes, fused einsum four-step below), the channel mix is a dense
complex contraction, and autodiff at staged sizes rides the library's
linear-call transpose seam (backward pass = one inverse-family transform,
not a retraced tangent graph).

Layout contract: channels-last activations ``(B, spatial..., C)`` as flax
expects; internally the channel dim folds into the FFT batch so every
transform is one batched dispatch — the same launch-amortization the
reference's batch API exists for (reference ``src/fft.rs:117-143``).

Split-complex throughout: spectra are ``(real, imag)`` f32 pairs, matching
the library ABI — no complex64 on the transform path.
"""

from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp

from ..ops.fft2d import irfft2_device, rfft2_device
from ..ops.transform import irfft_device, rfft_device

__all__ = ["SpectralConv1d", "SpectralConv2d", "FNO1d", "FNO2d", "append_grid"]


def _cmul_mix(yr, yi, wr, wi):
    """Complex channel contraction ``(B, C, *modes) x (C, O, *modes)``.

    One complex multiply-accumulate over the channel axis per kept mode:
    four real einsums, each a contraction over channels with the mode grid
    as free axes.  Split-complex in, split-complex out.
    """
    sub = "xy"[: yr.ndim - 2]
    spec = f"bc{sub},co{sub}->bo{sub}"
    rr = jnp.einsum(spec, yr, wr) - jnp.einsum(spec, yi, wi)
    ii = jnp.einsum(spec, yr, wi) + jnp.einsum(spec, yi, wr)
    return rr, ii


class SpectralConv1d(nn.Module):
    """Spectral convolution: per-mode dense channel mix in rfft space.

    Keeps the ``modes`` lowest frequency bins of a length-``L`` signal
    (power-of-two ``L``), mixes channels with a learned complex matrix per
    bin, zero-fills the rest, and inverts.  A global-receptive-field
    convolution for the cost of two transforms and one einsum.
    """

    out_channels: int
    modes: int

    @nn.compact
    def __call__(self, x):
        """``x``: (B, L, C) real f32 -> (B, L, out_channels)."""
        b, length, c = x.shape
        half = length // 2 + 1
        if not (0 < self.modes <= half):
            raise ValueError(f"modes must be in [1, {half}], got {self.modes}")
        scale = 1.0 / (c * self.out_channels)
        shape = (c, self.out_channels, self.modes)
        wr = self.param("w_real", nn.initializers.normal(scale), shape)
        wi = self.param("w_imag", nn.initializers.normal(scale), shape)

        # (B, L, C) -> (B*C, L): channels fold into the FFT batch.
        xc = jnp.transpose(x, (0, 2, 1)).reshape(b * c, length)
        yr, yi = rfft_device(xc)
        yr = yr.reshape(b, c, half)[:, :, : self.modes]
        yi = yi.reshape(b, c, half)[:, :, : self.modes]
        zr, zi = _cmul_mix(yr, yi, wr, wi)
        pad = [(0, 0), (0, 0), (0, half - self.modes)]
        zr = jnp.pad(zr, pad).reshape(b * self.out_channels, half)
        zi = jnp.pad(zi, pad).reshape(b * self.out_channels, half)
        out = irfft_device(zr, zi).reshape(b, self.out_channels, length)
        return jnp.transpose(out, (0, 2, 1))


class SpectralConv2d(nn.Module):
    """2-D spectral convolution over the rfft2 corner modes.

    Keeps ``modes1`` row frequencies from EACH end of the height axis (the
    positive and negative low frequencies — the one-sided rfft2 layout
    stores them at the top and bottom of the row axis) and the ``modes2``
    lowest column bins, as in the original FNO.  Transforms ride
    :func:`gpu_fft_tpu.rfft2_device` / :func:`gpu_fft_tpu.irfft2_device`.
    """

    out_channels: int
    modes1: int
    modes2: int

    @nn.compact
    def __call__(self, x):
        """``x``: (B, H, W, C) real f32 -> (B, H, W, out_channels)."""
        b, h, w, c = x.shape
        hw = w // 2 + 1
        if not (0 < self.modes1 <= h // 2):
            raise ValueError(f"modes1 must be in [1, {h // 2}], got {self.modes1}")
        if not (0 < self.modes2 <= hw):
            raise ValueError(f"modes2 must be in [1, {hw}], got {self.modes2}")
        m1, m2, o = self.modes1, self.modes2, self.out_channels
        scale = 1.0 / (c * o)
        shape = (c, o, m1, m2)
        w1r = self.param("w1_real", nn.initializers.normal(scale), shape)
        w1i = self.param("w1_imag", nn.initializers.normal(scale), shape)
        w2r = self.param("w2_real", nn.initializers.normal(scale), shape)
        w2i = self.param("w2_imag", nn.initializers.normal(scale), shape)

        xc = jnp.transpose(x, (0, 3, 1, 2)).reshape(b * c, h, w)
        yr, yi = rfft2_device(xc)
        yr = yr.reshape(b, c, h, hw)
        yi = yi.reshape(b, c, h, hw)

        tr, ti = _cmul_mix(yr[:, :, :m1, :m2], yi[:, :, :m1, :m2], w1r, w1i)
        br, bi = _cmul_mix(yr[:, :, h - m1 :, :m2], yi[:, :, h - m1 :, :m2], w2r, w2i)
        gap = jnp.zeros((b, o, h - 2 * m1, m2), tr.dtype)
        zr = jnp.concatenate([tr, gap, br], axis=2)
        zi = jnp.concatenate([ti, gap, bi], axis=2)
        pad = [(0, 0), (0, 0), (0, 0), (0, hw - m2)]
        zr = jnp.pad(zr, pad).reshape(b * o, h, hw)
        zi = jnp.pad(zi, pad).reshape(b * o, h, hw)
        out = irfft2_device(zr, zi).reshape(b, o, h, w)
        return jnp.transpose(out, (0, 2, 3, 1))


def append_grid(x):
    """Append normalized coordinate channels to ``(B, spatial..., C)``.

    The standard FNO input featurization: the model sees where each sample
    sits in the domain.  1-D inputs gain one channel, 2-D inputs two.
    """
    b = x.shape[0]
    spatial = x.shape[1:-1]
    coords = [
        jnp.linspace(0.0, 1.0, s, endpoint=False, dtype=jnp.float32)
        for s in spatial
    ]
    grids = jnp.meshgrid(*coords, indexing="ij")
    tiled = [jnp.broadcast_to(g[None, ..., None], (b, *spatial, 1)) for g in grids]
    return jnp.concatenate([x, *tiled], axis=-1)


class _FNOBase(nn.Module):
    """Shared lift -> spectral blocks -> project scaffold."""

    width: int
    depth: int
    out_channels: int
    with_grid: bool

    def _run(self, x, make_spectral):
        if self.with_grid:
            x = append_grid(x)
        x = nn.Dense(self.width, name="lift")(x)
        for i in range(self.depth):
            y = make_spectral(i)(x)
            y = y + nn.Dense(self.width, name=f"pw{i}")(x)  # 1x1 conv skip
            x = nn.gelu(y) if i < self.depth - 1 else y
        x = nn.gelu(nn.Dense(2 * self.width, name="proj0")(x))
        return nn.Dense(self.out_channels, name="proj1")(x)


class FNO1d(_FNOBase):
    """1-D Fourier Neural Operator: ``(B, L, C) -> (B, L, out_channels)``.

    ``L`` must be a power of two (the library's native dispatch domain;
    use :func:`gpu_fft_tpu.resample_device` to regrid arbitrary inputs).
    """

    modes: int = 16
    width: int = 64
    depth: int = 4
    out_channels: int = 1
    with_grid: bool = True

    @nn.compact
    def __call__(self, x):
        return self._run(
            x,
            lambda i: SpectralConv1d(self.width, self.modes, name=f"spec{i}"),
        )


class FNO2d(_FNOBase):
    """2-D Fourier Neural Operator: ``(B, H, W, C) -> (B, H, W, out_channels)``.

    Power-of-two sides.  Data-parallel scaling is one ``shard_map`` over the
    batch axis away (see ``gpu_fft_tpu.models.train.data_parallel_step``);
    the spectral mix is replicated, transforms stay shard-local.
    """

    modes1: int = 12
    modes2: int = 12
    width: int = 32
    depth: int = 4
    out_channels: int = 1
    with_grid: bool = True

    @nn.compact
    def __call__(self, x):
        return self._run(
            x,
            lambda i: SpectralConv2d(
                self.width, self.modes1, self.modes2, name=f"spec{i}"
            ),
        )
