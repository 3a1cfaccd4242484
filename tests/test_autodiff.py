"""Autodiff through the transform paths (grad / jvp / vjp at every size).

The transforms are linear maps, so two exact oracles exist with no
numerics beyond the transform's own: Parseval's theorem gives the
closed-form gradient of the spectrum power (d/dx sum|X|^2 = 2*n*x), and
the dot test <L v, w> == <v, L^T w> checks the vjp against the jvp.
transform_any's staged path routes both AD modes through the forward
dispatch itself (linear_call + the DFT's F^T = F symmetry: transpose =
conj . T . conj), while inverse_real's fold paths are plain jnp that XLA
differentiates — so both modes must work at FUSED and STAGED sizes on
every entry point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gpu_fft_tpu as gf
from gpu_fft_tpu.kernels.large import inverse_real, transform_any

SIZES = [512, 4096, 1 << 17]  # direct, fused four-step, staged


def _power(v):
    yr, yi = gf.fft_device(v)
    return jnp.sum(yr**2 + yi**2)


@pytest.mark.parametrize("n", SIZES)
def test_grad_parseval(rng, n):
    x = jnp.asarray(rng.standard_normal((1, n)).astype(np.float32))
    g = jax.grad(_power)(x)
    # Parseval: sum|X|^2 = n * sum x^2, so the gradient is exactly 2*n*x.
    assert float(jnp.abs(g - 2 * n * x).max()) / (2 * n) < 5e-6, f"n={n}"


@pytest.mark.parametrize("n", SIZES)
def test_jvp_forward_mode(rng, n):
    x = jnp.asarray(rng.standard_normal((1, n)).astype(np.float32))
    out, tangent = jax.jvp(_power, (x,), (x,))
    # homogeneous quadratic: directional derivative along x is 2*f(x)
    assert abs(float(tangent) / float(out) - 2.0) < 1e-4, f"n={n}"


def _dot_test(fn, ins, outs, rng, tol, label):
    v = [jnp.asarray(rng.standard_normal(s).astype(np.float32)) for s in ins]
    w = [jnp.asarray(rng.standard_normal(s).astype(np.float32)) for s in outs]
    out, vjp = jax.vjp(fn, *v)
    out_t = out if isinstance(out, tuple) else (out,)
    # accumulate the inner products in f64 on the host: the ~n-term f32 sum
    # would otherwise dominate the error being measured
    d64 = lambda a, b: float(np.vdot(np.asarray(a, np.float64), np.asarray(b, np.float64)))
    lhs = sum(d64(o, ww) for o, ww in zip(out_t, w))
    back = vjp(tuple(w) if isinstance(out, tuple) else w[0])
    rhs = sum(d64(b, vv) for b, vv in zip(back, v) if b is not None)
    assert abs(lhs - rhs) / max(1.0, abs(lhs)) < tol, f"{label}: {lhs} vs {rhs}"


@pytest.mark.parametrize("n", SIZES)
def test_vjp_dot_test_real_forward(rng, n):
    _dot_test(
        lambda a: gf.fft_device(a), [(2, n)], [(2, n), (2, n)], rng, 1e-4,
        f"fft_device n={n}",
    )


@pytest.mark.parametrize("n", [4096, 1 << 17])
def test_vjp_dot_test_complex_and_inverse(rng, n):
    _dot_test(
        lambda a, b: transform_any(a, b, n, -1),
        [(2, n), (2, n)], [(2, n), (2, n)], rng, 1e-4,
        f"transform_any n={n}",
    )
    _dot_test(
        lambda a, b: inverse_real(a, b, n),
        [(1, n), (1, n)], [(1, n)], rng, 1e-4,
        f"inverse_real n={n}",
    )


def test_grad_through_irfft_and_spectral_pipeline(rng):
    # a spectral-loss training step shape: stft-free but exercises
    # rfft -> filter -> irfft end to end at a staged size
    n = 1 << 17
    x = jnp.asarray(rng.standard_normal((n,)).astype(np.float32))
    mask = jnp.asarray(rng.uniform(0.5, 1.5, n // 2 + 1).astype(np.float32))

    def loss(v):
        sr, si = gf.rfft_device(v)
        y = gf.irfft_device(sr * mask, si * mask)
        return jnp.sum(y**2)

    g = jax.grad(loss)(x)
    assert g.shape == x.shape
    assert bool(jnp.all(jnp.isfinite(g)))
    # directional fd check along a random direction (f32-sized step)
    d = jnp.asarray(rng.standard_normal((n,)).astype(np.float32))
    eps = 1e-2
    fd = (loss(x + eps * d) - loss(x - eps * d)) / (2 * eps)
    an = float(jnp.vdot(g, d))
    assert abs(float(fd) - an) / max(1.0, abs(an)) < 5e-3


def test_grad_through_compat_namespace(rng):
    import gpu_fft_tpu.compat as cf

    x = jnp.asarray(rng.standard_normal((2, 48)).astype(np.float32))

    def loss(v):
        X = cf.rfft(v, n=64)
        return jnp.sum(jnp.abs(X) ** 2)

    g = jax.grad(loss)(x)
    # fd check: the loss is an exact quadratic, so the central difference is
    # exact at ANY step — a large eps avoids f32 cancellation in L+ - L-.
    d = jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))
    eps = 0.5
    fd = (loss(x + eps * d) - loss(x - eps * d)) / (2 * eps)
    assert abs(float(fd) - float(jnp.vdot(g, d))) / max(1.0, abs(float(fd))) < 5e-3


def test_grad_through_estimators(rng):
    # The common training-loss surfaces: STFT power, Welch PSD, spectrogram.
    # All are compositions of linear transforms + smooth elementwise ops, so
    # a central difference on the quadratic-ish losses pins the gradients.
    x = jnp.asarray(rng.standard_normal((4096,)).astype(np.float32))
    d = jnp.asarray(rng.standard_normal((4096,)).astype(np.float32))

    def fd_rel(loss, eps=1e-2):
        g = jax.grad(loss)(x)
        assert bool(jnp.all(jnp.isfinite(g)))
        fd = (loss(x + eps * d) - loss(x - eps * d)) / (2 * eps)
        an = float(jnp.vdot(g, d))
        return abs(float(fd) - an) / max(1.0, abs(an))

    def loss_stft(v):
        sr, si = gf.stft_device(v.reshape(1, -1), 256, 64)
        return jnp.sum(sr**2 + si**2)

    def loss_welch(v):
        _, p = gf.welch_device(v, fs=1.0, nperseg=256)
        return jnp.sum(p)

    def loss_spec(v):
        return jnp.sum(gf.spectrogram_device(v, 256, 64))

    assert fd_rel(loss_stft) < 5e-3
    assert fd_rel(loss_welch) < 5e-3
    assert fd_rel(loss_spec) < 5e-3
