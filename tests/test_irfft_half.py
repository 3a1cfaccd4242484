"""Real-output inverse Hermitian-fold path (kernels/fused_jnp.py:fused_irfft_jnp).

The dual of the forward half-spectrum path: real-output inverses fold the
conjugate half of the input spectrum before the matmuls for
n >= tuning.irfft_half_min (2^15 in the h100 row).
The CPU test mesh mirrors the h100 tuning row, so both sides of the gate are
exercised here: n = 2^14 takes the full complex inverse, n >= 2^15 the fold.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpu_fft_tpu.kernels.fused_jnp import fused_irfft_jnp
from gpu_fft_tpu.kernels.large import inverse_real, transform_any
from gpu_fft_tpu.plan import get_irfft_plan, irfft_half_applies


def _hermitian_spectrum(rng, b, n):
    x = rng.standard_normal((b, n)).astype(np.float32)
    X = np.fft.fft(x.astype(np.float64), axis=-1)
    return x, X.real.astype(np.float32), X.imag.astype(np.float32)


def _bound(n):
    return 5 * np.log2(n) * np.finfo(np.float32).eps


@pytest.mark.parametrize("n", [16, 256, 4096, 1 << 14, 1 << 15, 1 << 16])
@pytest.mark.parametrize("b", [1, 3])
def test_fused_irfft_matches_numpy(n, b):
    """The fold kernel itself reconstructs the signal at every fused size."""
    rng = np.random.default_rng(n + b)
    x, xr, xi = _hermitian_spectrum(rng, b, n)
    plan = get_irfft_plan(n, scale=1.0 / n)
    out = np.asarray(fused_irfft_jnp(jnp.asarray(xr), jnp.asarray(xi), plan))
    err = np.abs(out - x).max() / np.abs(x).max()
    assert err < _bound(n), f"n={n} b={b}: relative error {err:.2e}"


@pytest.mark.parametrize("n", [1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18])
def test_inverse_real_dispatch_matches_full_inverse(n):
    """inverse_real == transform_any(+1).real on both sides of both gates
    (2^14 full path, 2^15/2^16 fused fold, 2^17 staged fallback, 2^18
    half-column stage A + per-row stage-B fold)."""
    rng = np.random.default_rng(n)
    x, xr, xi = _hermitian_spectrum(rng, 2, n)
    got = np.asarray(inverse_real(jnp.asarray(xr), jnp.asarray(xi), n, scale=1.0 / n))
    ref, _ = transform_any(jnp.asarray(xr), jnp.asarray(xi), n, +1, scale=1.0 / n)
    np.testing.assert_allclose(got, np.asarray(ref), atol=5e-4 * np.abs(x).max())
    err = np.abs(got - x).max() / np.abs(x).max()
    assert err < _bound(n)


def test_gate_is_tuning_driven():
    from gpu_fft_tpu.plan import irfft_half_staged_applies

    assert not irfft_half_applies(1 << 14)
    assert irfft_half_applies(1 << 15)
    assert not irfft_half_staged_applies(1 << 17)
    assert irfft_half_staged_applies(1 << 18)


def test_plan_rejects_bad_n():
    with pytest.raises(ValueError):
        get_irfft_plan(48)  # not a power of two
    with pytest.raises(ValueError):
        get_irfft_plan(8)  # below the minimum


def test_unnormalized_scale_none():
    """scale=None means the unnormalized inverse (n * signal)."""
    rng = np.random.default_rng(7)
    n = 1 << 15
    x, xr, xi = _hermitian_spectrum(rng, 1, n)
    out = np.asarray(inverse_real(jnp.asarray(xr), jnp.asarray(xi), n))
    err = np.abs(out / n - x).max() / np.abs(x).max()
    assert err < _bound(n)


def test_oaconvolve_large_block_rides_fold():
    """A block length past the gate (2^15) keeps scipy parity."""
    from gpu_fft_tpu.ops.filter import oaconvolve

    scipy_signal = pytest.importorskip("scipy.signal")
    rng = np.random.default_rng(11)
    x = rng.standard_normal(100_000).astype(np.float32)
    h = rng.standard_normal(4_097).astype(np.float32)
    got = oaconvolve(x, h, block=1 << 15)
    ref = scipy_signal.oaconvolve(x.astype(np.float64), h.astype(np.float64))
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 2e-5


@pytest.mark.parametrize("n", [1 << 15, 1 << 16])
def test_irfft_device_roundtrip_past_gate(n):
    from gpu_fft_tpu.ops.transform import irfft_device, rfft_device

    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n)).astype(np.float32)
    yr, yi = rfft_device(jnp.asarray(x))
    back = np.asarray(irfft_device(yr, yi))
    err = np.abs(back - x).max() / np.abs(x).max()
    assert err < 2 * _bound(n)


# ── Direct half-input path (n <= DIRECT_MAX): Hermitian fold in the tables ───


@pytest.mark.parametrize("n", [2, 4, 16, 64, 256, 512])
@pytest.mark.parametrize("b", [1, 5])
def test_direct_half_matches_numpy(n, b):
    """inverse_real_half at direct sizes: two real dots, contraction h,
    no mirror (plan.get_irfft_direct_plan)."""
    from gpu_fft_tpu.kernels.large import inverse_real_half

    rng = np.random.default_rng(n + b)
    x, xr, xi = _hermitian_spectrum(rng, b, n)
    h = n // 2 + 1
    out = np.asarray(
        inverse_real_half(
            jnp.asarray(xr[:, :h]), jnp.asarray(xi[:, :h]), n, scale=1.0 / n
        )
    )
    err = np.abs(out - x).max() / max(np.abs(x).max(), 1e-30)
    assert err < max(_bound(n), 2e-6), f"n={n} b={b}: relative error {err:.2e}"


def test_direct_half_ignores_dc_nyquist_imag():
    """The sin rows at k = 0 and k = n/2 are exactly zero, so stray
    imaginary parts in the DC/Nyquist bins cannot leak into the output
    (numpy irfft semantics, with no masking pass)."""
    from gpu_fft_tpu.kernels.large import inverse_real_half

    n, h = 256, 129
    rng = np.random.default_rng(0)
    fr = rng.standard_normal((2, h)).astype(np.float32)
    fi = rng.standard_normal((2, h)).astype(np.float32)
    got = np.asarray(inverse_real_half(jnp.asarray(fr), jnp.asarray(fi), n, scale=1.0 / n))
    ref = np.fft.irfft(fr + 1j * fi, n=n, axis=-1)  # numpy also ignores them
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("n", [4, 256, 512, 1024, 1 << 15])
def test_irfft_device_one_sided_roundtrip(n):
    """rfft_device -> irfft_device recovers the signal at direct sizes
    (table-fold path), mid fused sizes (mirror + full inverse), and fold
    sizes (mirror + grid fold, mirror DCE'd)."""
    from gpu_fft_tpu.ops.transform import irfft_device, rfft_device

    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    fr, fi = rfft_device(jnp.asarray(x))
    assert fr.shape == (3, n // 2 + 1)
    y = np.asarray(irfft_device(fr, fi))
    err = np.abs(y - x).max() / np.abs(x).max()
    assert err < _bound(n), f"n={n}: relative error {err:.2e}"


def test_direct_half_plan_rejects_bad_n():
    from gpu_fft_tpu.plan import get_irfft_direct_plan

    with pytest.raises(ValueError):
        get_irfft_direct_plan(3)
    with pytest.raises(ValueError):
        get_irfft_direct_plan(1024)  # beyond DIRECT_MAX: the fold path owns it


def test_direct_half_grad_flows():
    """The direct path is two dots — reverse mode must flow through
    irfft_device for training losses on reconstructed signals."""
    import jax

    from gpu_fft_tpu.ops.transform import irfft_device

    n, h = 64, 33
    rng = np.random.default_rng(1)
    fr = jnp.asarray(rng.standard_normal((1, h)).astype(np.float32))
    fi = jnp.asarray(rng.standard_normal((1, h)).astype(np.float32))
    g = jax.grad(lambda a, b: jnp.sum(irfft_device(a, b) ** 2), argnums=(0, 1))(fr, fi)
    assert np.isfinite(np.asarray(g[0])).all() and np.isfinite(np.asarray(g[1])).all()


class TestOneSidedDirectGridEngine:
    """fused_irfft_half_jnp: the fold grid assembled STRAIGHT from the
    one-sided bins.  No dispatch routes to it (the full mirror is the
    fused-size dispatch), but the engine stays correct and oracle-pinned,
    the same disposition as the fft2 axis-0 pass."""

    @pytest.mark.parametrize("n", [1 << 15, 1 << 16])
    @pytest.mark.parametrize("b", [1, 3])
    def test_matches_numpy_irfft(self, n, b):
        from gpu_fft_tpu.kernels.fused_jnp import fused_irfft_half_jnp
        from gpu_fft_tpu.plan import get_irfft_plan

        rng = np.random.default_rng(0)
        x = rng.standard_normal((b, n)).astype(np.float32)
        sp = np.fft.rfft(x.astype(np.float64))
        y = np.asarray(
            fused_irfft_half_jnp(
                jnp.asarray(sp.real.astype(np.float32)),
                jnp.asarray(sp.imag.astype(np.float32)),
                get_irfft_plan(n, scale=1.0 / n),
            )
        )
        err = np.abs(y - x).max()
        assert err < _bound(n), f"n={n} b={b}: error {err:.2e}"

    def test_ignores_dc_nyquist_imag(self):
        """numpy irfft semantics: dirty imaginary parts in bins 0 and n/2
        must not change the output."""
        from gpu_fft_tpu.kernels.fused_jnp import fused_irfft_half_jnp
        from gpu_fft_tpu.plan import get_irfft_plan

        n = 1 << 15
        rng = np.random.default_rng(1)
        x = rng.standard_normal((1, n)).astype(np.float32)
        sp = np.fft.rfft(x.astype(np.float64))
        xr = jnp.asarray(sp.real.astype(np.float32))
        xi = jnp.asarray(sp.imag.astype(np.float32)).at[:, 0].set(7.0).at[:, -1].set(-3.0)
        y = np.asarray(fused_irfft_half_jnp(xr, xi, get_irfft_plan(n, scale=1.0 / n)))
        assert np.abs(y - x).max() < _bound(n)


class TestDirectK128Variant:
    """Power-of-two-deep direct half inverse (tuning.irfft_direct_k128):
    K = n/2 dots + Nyquist broadcast instead of the h = n/2 + 1 deep
    contraction."""

    @pytest.mark.parametrize("n", [256, 512])
    @pytest.mark.parametrize("b", [1, 5])
    def test_matches_numpy_and_shipped(self, n, b):
        from gpu_fft_tpu.kernels.fused_jnp import (
            irfft_direct_half_jnp,
            irfft_direct_half_k128_jnp,
        )
        from gpu_fft_tpu.plan import (
            get_irfft_direct_k128_plan,
            get_irfft_direct_plan,
        )

        rng = np.random.default_rng(9)
        x = rng.standard_normal((b, n)).astype(np.float32)
        sp = np.fft.rfft(x.astype(np.float64))
        xr = jnp.asarray(sp.real.astype(np.float32))
        xi = jnp.asarray(sp.imag.astype(np.float32))
        a = np.asarray(
            irfft_direct_half_jnp(xr, xi, get_irfft_direct_plan(n, scale=1.0 / n))
        )
        y = np.asarray(
            irfft_direct_half_k128_jnp(
                xr, xi, get_irfft_direct_k128_plan(n, scale=1.0 / n)
            )
        )
        assert np.abs(y - x).max() < _bound(n)
        assert np.abs(y - a).max() < _bound(n)

    def test_ignores_dc_nyquist_imag(self):
        from gpu_fft_tpu.kernels.fused_jnp import irfft_direct_half_k128_jnp
        from gpu_fft_tpu.plan import get_irfft_direct_k128_plan

        n = 256
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, n)).astype(np.float32)
        sp = np.fft.rfft(x.astype(np.float64))
        xr = jnp.asarray(sp.real.astype(np.float32))
        xi = jnp.asarray(sp.imag.astype(np.float32)).at[:, 0].set(5.0).at[:, -1].set(-2.0)
        y = np.asarray(
            irfft_direct_half_k128_jnp(xr, xi, get_irfft_direct_k128_plan(n, scale=1.0 / n))
        )
        assert np.abs(y - x).max() < _bound(n)


class TestRfftDirectPacked:
    """One-dot packed direct real forward (no dispatch gate routes to it):
    [C | S-interior] in one (n, n) table; PSD reduces the packed product
    without an unpack pass."""

    @pytest.mark.parametrize("n", [256, 512])
    def test_matches_numpy(self, n):
        from gpu_fft_tpu.kernels.fused_jnp import rfft_direct_packed_jnp
        from gpu_fft_tpu.plan import get_rfft_direct_packed_plan

        rng = np.random.default_rng(3)
        x = rng.standard_normal((4, n)).astype(np.float32)
        _, fr, fi = rfft_direct_packed_jnp(
            jnp.asarray(x), get_rfft_direct_packed_plan(n)
        )
        ref = np.fft.rfft(x.astype(np.float64))
        s = np.abs(ref).max()
        assert np.abs(np.asarray(fr) - ref.real).max() / s < 1e-6
        assert np.abs(np.asarray(fi) - ref.imag).max() / s < 1e-6

    def test_packed_psd(self):
        from gpu_fft_tpu.kernels.fused_jnp import rfft_packed_psd_jnp
        from gpu_fft_tpu.plan import get_rfft_direct_packed_plan

        n = 256
        rng = np.random.default_rng(6)
        x = rng.standard_normal((7, n)).astype(np.float32)
        psd = np.asarray(
            rfft_packed_psd_jnp(jnp.asarray(x), get_rfft_direct_packed_plan(n))
        )
        ref = np.abs(np.fft.rfft(x.astype(np.float64))) ** 2
        assert np.abs(psd - ref).max() / ref.max() < 1e-5
