"""2-D FFT extension tests (oracle: numpy.fft.fft2/ifft2)."""

import numpy as np
import pytest

import gpu_fft_tpu as gf


def test_fft2_matches_numpy(rng):
    x = rng.uniform(-1.0, 1.0, (64, 128)).astype(np.float32)
    re, im = gf.fft2(x)
    ref = np.fft.fft2(x.astype(np.float64))
    scale = np.abs(ref).max()
    assert np.abs(re - ref.real).max() / scale < 1e-5
    assert np.abs(im - ref.imag).max() / scale < 1e-5


def test_fft2_complex_input(rng):
    xr = rng.uniform(-1.0, 1.0, (32, 32)).astype(np.float32)
    xi = rng.uniform(-1.0, 1.0, (32, 32)).astype(np.float32)
    yr, yi = gf.fft2_device(xr, xi)
    ref = np.fft.fft2(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr) - ref.real).max() / scale < 1e-5
    assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 1e-5


def test_ifft2_roundtrip(rng):
    x = rng.uniform(-1.0, 1.0, (16, 64)).astype(np.float32)
    re, im = gf.fft2(x)
    rr, ri = gf.ifft2(re, im)
    eps = 5.0 * np.log2(16 * 64) * np.finfo(np.float32).eps
    assert np.abs(rr - x).max() <= eps
    assert np.abs(ri).max() <= eps


def test_fft2_batched_leading_dims(rng):
    x = rng.uniform(-1.0, 1.0, (3, 16, 32)).astype(np.float32)
    re, im = gf.fft2(x)
    ref = np.fft.fft2(x.astype(np.float64), axes=(-2, -1))
    scale = np.abs(ref).max()
    assert re.shape == x.shape
    assert np.abs(re - ref.real).max() / scale < 1e-5
    assert np.abs(im - ref.imag).max() / scale < 1e-5


def test_fft2_rejects_bad_shapes():
    with pytest.raises(ValueError):
        gf.fft2(np.zeros(16, np.float32))  # 1-D
    with pytest.raises(ValueError):
        gf.fft2(np.zeros((1, 16), np.float32))  # height < 2
    with pytest.raises(ValueError):
        gf.ifft2(np.zeros((4, 4), np.float32), np.zeros((4, 8), np.float32))


def test_fft2_non_pow2_sides_exact(rng):
    # Non-pow2 sides run exactly via Bluestein — numpy.fft.fft2 semantics,
    # never padding.
    for h, w in ((3, 16), (12, 25), (100, 64)):
        x = rng.uniform(-1.0, 1.0, (h, w)).astype(np.float32)
        re, im = gf.fft2(x)
        ref = np.fft.fft2(x.astype(np.float64))
        scale = np.abs(ref).max()
        assert re.shape == (h, w)
        assert np.abs(re - ref.real).max() / scale < 3e-5, (h, w)
        assert np.abs(im - ref.imag).max() / scale < 3e-5, (h, w)
    # and the inverse roundtrips
    x = rng.uniform(-1.0, 1.0, (25, 12)).astype(np.float32)
    rr, ri = gf.ifft2(*gf.fft2(x))
    assert np.abs(rr - x).max() < 1e-4
    assert np.abs(ri).max() < 1e-4


def test_fft2_large_side_uses_staged_path(rng):
    # One side beyond FUSED_MAX exercises the staged 1-D path inside fft2.
    from gpu_fft_tpu.config import FUSED_MAX

    x = rng.uniform(-1.0, 1.0, (2, 2 * FUSED_MAX)).astype(np.float32)
    re, im = gf.fft2(x)
    ref = np.fft.fft2(x.astype(np.float64))
    scale = np.abs(ref).max()
    assert np.abs(re - ref.real).max() / scale < 1e-5
    assert np.abs(im - ref.imag).max() / scale < 1e-5


def test_fftn_3d_matches_numpy(rng):
    x = rng.uniform(-1.0, 1.0, (4, 8, 16)).astype(np.float32)
    re, im = gf.fftn(x)
    ref = np.fft.fftn(x.astype(np.float64))
    scale = np.abs(ref).max()
    assert np.abs(re - ref.real).max() / scale < 2e-5
    assert np.abs(im - ref.imag).max() / scale < 2e-5


def test_fftn_axes_subset_and_non_pow2(rng):
    x = rng.uniform(-1.0, 1.0, (5, 12, 16)).astype(np.float32)
    re, im = gf.fftn(x, axes=(1, 2))  # leading dim untouched; 12 via Bluestein
    ref = np.fft.fftn(x.astype(np.float64), axes=(1, 2))
    scale = np.abs(ref).max()
    assert np.abs(re - ref.real).max() / scale < 3e-5
    assert np.abs(im - ref.imag).max() / scale < 3e-5


def test_ifftn_roundtrip(rng):
    x = rng.uniform(-1.0, 1.0, (4, 8, 32)).astype(np.float32)
    rr, ri = gf.ifftn(*gf.fftn(x))
    assert np.abs(rr - x).max() < 1e-4
    assert np.abs(ri).max() < 1e-4


def test_ifftn_device_roundtrip_and_axes(rng):
    # Device-side inverse (public symmetry partner of fftn_device): full
    # roundtrip and an axis-subset case, everything staying on device.
    x = rng.uniform(-1.0, 1.0, (3, 8, 16)).astype(np.float32)
    yr, yi = gf.fftn_device(x)
    rr, ri = gf.ifftn_device(yr, yi)
    assert np.abs(np.asarray(rr) - x).max() < 1e-4
    assert np.abs(np.asarray(ri)).max() < 1e-4
    yr, yi = gf.fftn_device(x, axes=(1,))
    rr, ri = gf.ifftn_device(yr, yi, axes=(1,))
    assert np.abs(np.asarray(rr) - x).max() < 1e-4


def test_fftn_errors():
    with pytest.raises(ValueError):
        gf.fftn(np.zeros((4, 1), np.float32))  # axis length < 2
    with pytest.raises(ValueError):
        gf.fftn(np.zeros((4, 8), np.float32), axes=(0, 0))  # repeated axes


def test_fftn_rejects_empty_axes():
    with pytest.raises(ValueError):
        gf.fftn(np.zeros((4, 8), np.float32), axes=())


def test_fftn_rejects_out_of_range_axes():
    x = np.zeros((4, 8), np.float32)
    with pytest.raises(ValueError):
        gf.fftn(x, axes=(2,))
    with pytest.raises(ValueError):
        gf.fftn(x, axes=(-3,))
    # valid negative axes still work
    re, im = gf.fftn(np.random.default_rng(0).uniform(-1, 1, (4, 8)).astype(np.float32),
                     axes=(-1,))
    assert re.shape == (4, 8)


# ── rfft2 / irfft2 ───────────────────────────────────────────────────────────


@pytest.mark.parametrize("shape", [(8, 16), (32, 64), (128, 128)])
def test_rfft2_matches_numpy(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    yr, yi = gf.rfft2(x)
    ref = np.fft.rfft2(x.astype(np.float64))
    assert yr.shape == ref.shape == (shape[0], shape[1] // 2 + 1)
    scale = np.abs(ref).max()
    assert np.abs(yr - ref.real).max() / scale < 3e-5
    assert np.abs(yi - ref.imag).max() / scale < 3e-5


def test_rfft2_batched_roundtrip(rng):
    x = rng.standard_normal((5, 16, 32)).astype(np.float32)
    yr, yi = gf.rfft2(x)
    assert yr.shape == (5, 16, 17)
    back = gf.irfft2(yr, yi)
    assert back.shape == x.shape
    assert np.abs(back - x).max() < 1e-5


def test_irfft2_matches_numpy(rng):
    spec = np.fft.rfft2(rng.standard_normal((16, 64)))
    got = gf.irfft2(spec.real.astype(np.float32), spec.imag.astype(np.float32))
    ref = np.fft.irfft2(spec)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-5


def test_rfft2_jit_composable(rng):
    import jax

    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    f = jax.jit(lambda a: gf.irfft2_device(*gf.rfft2_device(a)))
    out = np.asarray(f(x))
    assert np.abs(out - x).max() < 1e-5


def test_rfft2_contract_errors(rng):
    with pytest.raises(ValueError):
        gf.rfft2(np.ones(8, np.float32))  # 1-D
    with pytest.raises(ValueError):
        gf.rfft2(np.ones((6, 8), np.float32))  # non-pow2 side
    with pytest.raises(ValueError):
        gf.irfft2(np.ones((8, 5), np.float32), np.ones((8, 4), np.float32))
    with pytest.raises(ValueError):
        gf.irfft2(np.ones((8, 6), np.float32), np.ones((8, 6), np.float32))  # bad bins


def test_rfftn_3d_matches_numpy(rng):
    x = rng.uniform(-1.0, 1.0, (4, 12, 32)).astype(np.float32)
    re, im = gf.rfftn(x)
    ref = np.fft.rfftn(x.astype(np.float64))
    assert re.shape == ref.shape == (4, 12, 17)
    scale = np.abs(ref).max()
    assert np.abs(re - ref.real).max() / scale < 1e-5
    assert np.abs(im - ref.imag).max() / scale < 1e-5


def test_rfftn_axes_subset_and_order(rng):
    # axes=(0, 2): real transform on axis 2 (the LAST listed), complex on 0.
    x = rng.uniform(-1.0, 1.0, (8, 5, 16)).astype(np.float32)
    re, im = gf.rfftn(x, axes=(0, 2))
    ref = np.fft.rfftn(x.astype(np.float64), axes=(0, 2))
    assert re.shape == ref.shape == (8, 5, 9)
    scale = np.abs(ref).max()
    assert np.abs(re - ref.real).max() / scale < 1e-5
    assert np.abs(im - ref.imag).max() / scale < 1e-5
    # Negative axes normalize like numpy.
    re2, _ = gf.rfftn(x, axes=(0, -1))
    assert np.abs(re2 - re).max() == 0.0


def test_rfftn_non_pow2_last_axis_exact(rng):
    # Non-pow2 real axis: full exact transform, sliced to the half spectrum.
    x = rng.uniform(-1.0, 1.0, (6, 15)).astype(np.float32)
    re, im = gf.rfftn(x)
    ref = np.fft.rfftn(x.astype(np.float64))
    assert re.shape == ref.shape == (6, 8)
    scale = np.abs(ref).max()
    assert np.abs(re - ref.real).max() / scale < 1e-5
    assert np.abs(im - ref.imag).max() / scale < 1e-5


def test_irfftn_matches_numpy(rng):
    spec = (
        rng.uniform(-1.0, 1.0, (6, 8, 9)) + 1j * rng.uniform(-1.0, 1.0, (6, 8, 9))
    ).astype(np.complex128)
    out = gf.irfftn(spec.real.astype(np.float32), spec.imag.astype(np.float32))
    ref = np.fft.irfftn(spec)
    assert out.shape == ref.shape == (6, 8, 16)
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(out - ref).max() / scale < 1e-4


def test_rfftn_roundtrip_3d(rng):
    x = rng.uniform(-1.0, 1.0, (3, 10, 64)).astype(np.float32)
    out = gf.irfftn(*gf.rfftn(x))
    eps = 5.0 * np.log2(3 * 10 * 64) * np.finfo(np.float32).eps
    assert np.abs(out - x).max() <= eps


def test_rfftn_jit_composable(rng):
    import jax

    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    f = jax.jit(lambda a: gf.irfftn_device(*gf.rfftn_device(a)))
    out = np.asarray(f(x))
    assert np.abs(out - x).max() < 1e-5


def test_rfftn_contract_errors():
    with pytest.raises(ValueError):
        gf.rfftn(np.float32(1.0))  # rank 0
    with pytest.raises(ValueError):
        gf.rfftn(np.ones((4, 1), np.float32))  # last axis < 2
    with pytest.raises(ValueError):
        gf.rfftn(np.ones((4, 8), np.float32), axes=(0, 0))  # repeated
    with pytest.raises(ValueError):
        gf.rfftn(np.ones((4, 8), np.float32), axes=(2,))  # out of range
    with pytest.raises(ValueError):
        # last axis bins not n//2 + 1 of a power of two
        gf.irfftn(np.ones((4, 6), np.float32), np.ones((4, 6), np.float32))
    with pytest.raises(ValueError):
        gf.irfftn(np.ones((4, 9), np.float32), np.ones((4, 8), np.float32))


def test_hfftn_matches_scipy(rng):
    import scipy.fft

    spec = (
        rng.uniform(-1.0, 1.0, (5, 6, 9)) + 1j * rng.uniform(-1.0, 1.0, (5, 6, 9))
    ).astype(np.complex128)
    out = gf.hfftn(spec.real.astype(np.float32), spec.imag.astype(np.float32))
    ref = scipy.fft.hfftn(spec)
    assert out.shape == ref.shape == (5, 6, 16)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() / scale < 1e-4


def test_ihfftn_matches_scipy(rng):
    import scipy.fft

    x = rng.uniform(-1.0, 1.0, (4, 6, 16)).astype(np.float32)
    re, im = gf.ihfftn(x)
    ref = scipy.fft.ihfftn(x.astype(np.float64))
    assert re.shape == ref.shape == (4, 6, 9)
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(re - ref.real).max() / scale < 1e-5
    assert np.abs(im - ref.imag).max() / scale < 1e-5


def test_hfft2_roundtrip_and_axes(rng):
    import scipy.fft

    spec = (
        rng.uniform(-1.0, 1.0, (3, 8, 5)) + 1j * rng.uniform(-1.0, 1.0, (3, 8, 5))
    ).astype(np.complex128)
    # hfft2 default axes=(-2, -1): real axis is the LAST (length 5 -> n=8).
    out = gf.hfft2(spec.real.astype(np.float32), spec.imag.astype(np.float32))
    ref = scipy.fft.hfft2(spec)
    assert out.shape == ref.shape == (3, 8, 8)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() / scale < 1e-4
    # ihfft2 of the real spectrum matches scipy's one-sided inverse.
    re2, im2 = gf.ihfft2(out)
    ref2 = scipy.fft.ihfft2(ref)
    scale2 = max(np.abs(ref2).max(), 1e-12)
    assert np.abs(re2 - ref2.real).max() / scale2 < 1e-5
    assert np.abs(im2 - ref2.imag).max() / scale2 < 1e-5


def test_hfftn_matches_1d_hfft(rng):
    # Rank-1 hfftn == the existing 1-D hfft (same dispatch underneath).
    re = rng.uniform(-1.0, 1.0, 17).astype(np.float32)
    im = rng.uniform(-1.0, 1.0, 17).astype(np.float32)
    a = gf.hfftn(re, im)
    b = gf.hfft(re, im)
    assert a.shape == b.shape == (32,)
    assert np.abs(a - b).max() < 1e-5


def test_hfftn_contract_errors():
    with pytest.raises(ValueError):
        gf.hfftn(np.ones((4, 6), np.float32), np.ones((4, 6), np.float32))  # 6 bins
    with pytest.raises(ValueError):
        gf.hfftn(np.ones((4, 9), np.float32), np.ones((4, 8), np.float32))  # mismatch
    with pytest.raises(ValueError):
        gf.ihfftn(np.ones((4, 12), np.float32))  # non-pow2 last axis
    with pytest.raises(ValueError):
        gf.ihfftn(np.float32(3.0))  # rank 0


def test_prev_fast_len():
    assert gf.prev_fast_len(1000) == 512
    assert gf.prev_fast_len(1024) == 1024
    assert gf.prev_fast_len(2) == 2
    assert gf.prev_fast_len(3, real=True) == 2
    with pytest.raises(ValueError):
        gf.prev_fast_len(1)


class TestAxis0ColumnPass:
    """The axis-0 folded-einsum column engine (kernels/fused_jnp.py).

    The dispatch gate is closed in every tuning row — these tests pin (a)
    that default,
    (b) the engine's correctness for a future re-opening, and (c) the
    fft2/rfft2/irfft2 dispatch branches under a forced gate.
    """

    def test_gate_off_by_default(self):
        from gpu_fft_tpu.plan import axis0_applies

        for h, w in ((2048, 512), (4096, 4096), (8192, 2048)):
            assert not axis0_applies(h, w)

    def test_engine_correctness(self, rng):
        import jax.numpy as jnp

        from gpu_fft_tpu.kernels.fused_jnp import transform_axis0

        for h, w, cx in ((64, 96, False), (512, 130, True), (2048, 64, False)):
            x = rng.standard_normal((h, w)).astype(np.float32)
            xi = rng.standard_normal((h, w)).astype(np.float32) if cx else None
            yr, yi = transform_axis0(
                jnp.asarray(x), None if xi is None else jnp.asarray(xi), h, -1
            )
            z = (x if xi is None else x + 1j * xi).astype(np.complex128)
            ref = np.fft.fft(z, axis=0)
            scale = max(1.0, np.abs(ref).max())
            assert np.abs(np.asarray(yr) - ref.real).max() / scale < 3e-6, (h, w, cx)
            assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 3e-6, (h, w, cx)
        # inverse direction with the scale folded into the tables
        x = rng.standard_normal((256, 48)).astype(np.float32)
        yr, yi = transform_axis0(jnp.asarray(x), None, 256, +1, scale=1.0 / 256)
        ref = np.fft.ifft(x.astype(np.complex128), axis=0)
        assert np.abs(np.asarray(yr) - ref.real).max() < 1e-6

    def test_dispatch_branches_under_forced_gate(self, rng, monkeypatch):
        import gpu_fft_tpu.plan as plan

        monkeypatch.setattr(plan, "axis0_applies", lambda h, w: h & (h - 1) == 0)
        h, w = 512, 96
        x = rng.standard_normal((h, w)).astype(np.float32)
        yr, yi = gf.fft2_device(x)
        ref = np.fft.fft2(x.astype(np.float64))
        scale = np.abs(ref).max()
        assert np.abs(np.asarray(yr) - ref.real).max() / scale < 3e-6
        assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 3e-6
        br, bi = gf.ifft2_device(yr, yi)
        assert np.abs(np.asarray(br) - x).max() < 5e-4
        # one-sided pair through the forced gate
        h, w = 256, 256
        x = rng.standard_normal((h, w)).astype(np.float32)
        yr, yi = gf.rfft2_device(x)
        ref = np.fft.rfft2(x.astype(np.float64))
        scale = np.abs(ref).max()
        assert np.abs(np.asarray(yr) - ref.real).max() / scale < 3e-6
        back = gf.irfft2_device(yr, yi)
        assert np.abs(np.asarray(back) - x).max() < 5e-4

    def test_batched_lead_through_forced_gate(self, rng, monkeypatch):
        import gpu_fft_tpu.plan as plan

        monkeypatch.setattr(plan, "axis0_applies", lambda h, w: True)
        x = rng.standard_normal((2, 128, 64)).astype(np.float32)
        yr, yi = gf.fft2_device(x)
        ref = np.fft.fft2(x.astype(np.float64))
        scale = np.abs(ref).max()
        assert np.abs(np.asarray(yr) - ref.real).max() / scale < 3e-6
        assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 3e-6
