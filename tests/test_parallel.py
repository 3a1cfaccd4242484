"""Sharded/multi-chip paths on the 8-device virtual CPU mesh.

The reference has nothing distributed to mirror (SURVEY §2.4); these tests
validate the scale-out extensions against the single-chip oracle.
"""

import numpy as np
import jax
import pytest
from jax.sharding import Mesh
from conftest import assert_slice_approx

from gpu_fft_tpu.parallel import (
    default_mesh,
    distributed_fft,
    distributed_ifft,
    fft_batch_sharded,
    ifft_batch_sharded,
)


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return default_mesh()


@pytest.fixture(scope="module")
def mesh2x4():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.asarray(devs[:8]).reshape(2, 4), ("dp", "sp"))


def test_fft_batch_sharded_matches_oracle(mesh8, rng):
    x = rng.standard_normal((16, 1024)).astype(np.float32)
    yr, yi = fft_batch_sharded(x, mesh8)
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    assert np.abs(np.asarray(yr) - ref.real).max() < 1e-2
    assert np.abs(np.asarray(yi) - ref.imag).max() < 1e-2


def test_ifft_batch_sharded_roundtrip(mesh8, rng):
    x = rng.standard_normal((8, 512)).astype(np.float32)
    yr, yi = fft_batch_sharded(x, mesh8)
    rr, ri = ifft_batch_sharded(yr, yi, mesh8)
    assert_slice_approx(np.asarray(rr), x, eps=1e-3, label="sharded roundtrip")
    assert np.abs(np.asarray(ri)).max() < 1e-3


def test_distributed_fft_matches_oracle(mesh2x4, rng):
    # 4096 = 64 x 64, both divisible by sp=4.
    x = rng.standard_normal((4, 4096)).astype(np.float32)
    yr, yi = distributed_fft(x, mesh2x4, sp_axis="sp", dp_axis="dp")
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr) - ref.real).max() / scale < 1e-5
    assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 1e-5


def test_distributed_roundtrip(mesh2x4, rng):
    x = rng.standard_normal((2, 1024)).astype(np.float32)
    yr, yi = distributed_fft(x, mesh2x4, sp_axis="sp", dp_axis="dp")
    rr, ri = distributed_ifft(yr, yi, mesh2x4, sp_axis="sp", dp_axis="dp")
    assert_slice_approx(np.asarray(rr), x, eps=1e-3, label="distributed roundtrip")
    assert np.abs(np.asarray(ri)).max() < 1e-3


def test_distributed_rejects_bad_factor(mesh2x4):
    with pytest.raises(ValueError):
        # n=8 < sp^2=16: no factorization has both digits divisible by 4.
        distributed_fft(np.zeros((1, 8), np.float32), mesh2x4, sp_axis="sp")


def test_distributed_mesh_aware_split(mesh2x4, rng):
    # 32 = 2^5: the balanced split (4, 8) has n1=4 == sp, already valid; but
    # 2^5 over sp=4 forces the clamp logic (a must stay in [2, 3]).  Also a
    # size whose BALANCED split would fail: n=16 over sp=4 -> must pick 4x4.
    for n in (16, 32):
        x = rng.standard_normal((2, n)).astype(np.float32)
        yr, yi = distributed_fft(x, mesh2x4, sp_axis="sp", dp_axis="dp")
        ref = np.fft.fft(x.astype(np.float64), axis=-1)
        scale = np.abs(ref).max()
        assert np.abs(np.asarray(yr) - ref.real).max() / scale < 1e-5, f"n={n}"
        assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 1e-5, f"n={n}"


def test_distributed_large_n_beyond_fused_max(mesh2x4, rng):
    # n = 2^18 > FUSED_MAX: the sp path at a size where the single-chip path
    # matters (round-1 verdict: sp was never tested past 4096).
    n = 1 << 18
    x = rng.standard_normal((2, n)).astype(np.float32)
    yr, yi = distributed_fft(x, mesh2x4, sp_axis="sp", dp_axis="dp")
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr) - ref.real).max() / scale < 2e-5
    assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 2e-5


def test_distributed_staged_local_transforms(mesh2x4, rng, monkeypatch):
    # Force the LOCAL row/column transforms through the staged large-N path
    # inside shard_map by shrinking FUSED_MAX, proving the sp composition
    # holds when local pieces are themselves multi-kernel.
    import gpu_fft_tpu.kernels.large as large
    import gpu_fft_tpu.plan as plan_mod

    monkeypatch.setattr(large, "FUSED_MAX", 256)
    monkeypatch.setattr(plan_mod, "FUSED_MAX", 256)
    plan_mod.get_stage_a_plan.cache_clear()
    try:
        n = 1 << 18  # balanced split 512 x 512: both locals staged (512 > 256)
        x = rng.standard_normal((1, n)).astype(np.float32)
        yr, yi = distributed_fft(x, mesh2x4, sp_axis="sp")
        ref = np.fft.fft(x.astype(np.float64), axis=-1)
        scale = np.abs(ref).max()
        assert np.abs(np.asarray(yr) - ref.real).max() / scale < 2e-5
    finally:
        plan_mod.get_stage_a_plan.cache_clear()


def test_distributed_rejects_indivisible_batch(mesh2x4):
    with pytest.raises(ValueError):
        distributed_fft(np.zeros((3, 4096), np.float32), mesh2x4, sp_axis="sp", dp_axis="dp")


def test_welch_sharded_matches_single_chip(mesh8, rng):
    from gpu_fft_tpu.ops.spectral import welch_device
    from gpu_fft_tpu.parallel import welch_sharded

    # 65 segments: deliberately NOT a multiple of the 8-device mesh — the
    # masked-remainder path must match single-chip welch over the SAME
    # (untruncated) signal, element-wise.
    x = rng.standard_normal(128 * 65 + 64).astype(np.float32)  # 65 hop-128 segs
    f, p = welch_sharded(x, mesh8, nperseg=256, fs=10.0)
    f_ref, p_ref = welch_device(x, nperseg=256, fs=10.0)
    assert_slice_approx(f, f_ref, 1e-9, "welch_sharded freqs")
    p, p_ref = np.asarray(p), np.asarray(p_ref)
    scale = p_ref.max()
    assert_slice_approx(p / scale, p_ref / scale, 1e-4, "welch_sharded psd")


@pytest.mark.parametrize("num_seg", [1, 7, 8, 9])
def test_welch_sharded_any_segment_count(mesh8, rng, num_seg):
    # Every remainder class around the mesh size, including fewer segments
    # than devices (idle devices contribute a masked zero partial).
    from gpu_fft_tpu.ops.spectral import welch_device
    from gpu_fft_tpu.parallel import welch_sharded

    x = rng.standard_normal(64 * (num_seg - 1) + 128).astype(np.float32)
    _, p = welch_sharded(x, mesh8, nperseg=128)
    _, p_ref = welch_device(x, nperseg=128)
    p, p_ref = np.asarray(p), np.asarray(p_ref)
    scale = p_ref.max()
    assert_slice_approx(p / scale, p_ref / scale, 1e-4, f"welch_sharded {num_seg} segs")


def test_welch_sharded_contracts(mesh8):
    from gpu_fft_tpu.parallel import welch_sharded

    with pytest.raises(ValueError):  # shorter than one segment
        welch_sharded(np.zeros(200, np.float32), mesh8, nperseg=256)
    with pytest.raises(ValueError):
        welch_sharded(np.zeros((4, 4096), np.float32), mesh8)


def test_fft2_batch_sharded_matches_oracle(mesh8, rng):
    x = rng.standard_normal((8, 16, 100)).astype(np.float32)  # non-pow2 width
    from gpu_fft_tpu.parallel import fft2_batch_sharded

    yr, yi = fft2_batch_sharded(x, mesh8)
    ref = np.fft.fft2(x.astype(np.float64), axes=(-2, -1))
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr) - ref.real).max() / scale < 3e-5
    assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 3e-5
    with pytest.raises(ValueError):
        fft2_batch_sharded(np.zeros((3, 16, 16), np.float32), mesh8)


def test_oaconvolve_sharded_matches_oracle(mesh8, rng):
    from gpu_fft_tpu.parallel import oaconvolve_sharded

    x = rng.standard_normal(40000).astype(np.float32)  # not divisible by 8
    h = rng.standard_normal(129).astype(np.float32)
    got = np.asarray(oaconvolve_sharded(x, h, mesh8))
    ref = np.convolve(x.astype(np.float64), h.astype(np.float64))
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 3e-5


def test_oaconvolve_sharded_jit(mesh8, rng):
    import jax

    from gpu_fft_tpu.parallel import oaconvolve_sharded

    x = rng.standard_normal(16384).astype(np.float32)
    h = rng.standard_normal(64).astype(np.float32)
    f = jax.jit(lambda a: oaconvolve_sharded(a, h, mesh8))
    got = np.asarray(f(x))
    ref = np.asarray(oaconvolve_sharded(x, h, mesh8))
    assert np.abs(got - ref).max() / max(1.0, np.abs(ref).max()) < 1e-5


def test_oaconvolve_sharded_contracts(mesh8):
    from gpu_fft_tpu.parallel import oaconvolve_sharded

    with pytest.raises(ValueError):  # single tap: no tail to exchange
        oaconvolve_sharded(np.ones(1024, np.float32), np.ones(1, np.float32), mesh8)
    with pytest.raises(ValueError):  # taps longer than one device's chunk
        oaconvolve_sharded(np.ones(64, np.float32), np.ones(32, np.float32), mesh8)


def test_fft2_sharded_pencil_matches_oracle(mesh8, rng):
    from gpu_fft_tpu.parallel import fft2_sharded, ifft2_sharded

    x = rng.standard_normal((64, 128)).astype(np.float32)
    yr, yi = fft2_sharded(x, mesh8, sp_axis="dp")
    ref = np.fft.fft2(x.astype(np.float64))
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr) - ref.real).max() / scale < 3e-5
    assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 3e-5
    br, bi = ifft2_sharded(yr, yi, mesh8, sp_axis="dp")
    assert np.abs(np.asarray(br) - x).max() < 1e-4
    assert np.abs(np.asarray(bi)).max() < 1e-4


def test_fft2_sharded_complex_and_batch(mesh2x4, rng):
    from gpu_fft_tpu.parallel import fft2_sharded

    xb = rng.standard_normal((4, 32, 64)).astype(np.float32)
    zb = rng.standard_normal((4, 32, 64)).astype(np.float32)
    yr, yi = fft2_sharded(xb, mesh2x4, dp_axis="dp", imag=zb)
    ref = np.fft.fft2((xb + 1j * zb).astype(np.complex128))
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr) - ref.real).max() / scale < 3e-5
    assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 3e-5


def test_fft2_sharded_layout_stays_row_sharded(mesh8, rng):
    # the result must keep the input's row sharding (no silent gather)
    from gpu_fft_tpu.parallel import fft2_sharded

    x = rng.standard_normal((64, 64)).astype(np.float32)
    yr, _ = fft2_sharded(x, mesh8, sp_axis="dp")
    spec = yr.sharding.spec
    assert spec[0] == "dp" and (len(spec) < 2 or spec[1] is None), spec


def test_fft2_sharded_contracts(mesh8):
    from gpu_fft_tpu.parallel import fft2_sharded

    with pytest.raises(ValueError, match="power-of-two"):
        fft2_sharded(np.ones((48, 64), np.float32), mesh8, sp_axis="dp")
    with pytest.raises(ValueError, match="divide"):
        fft2_sharded(np.ones((4, 64), np.float32), mesh8, sp_axis="dp")
    with pytest.raises(ValueError, match="shapes differ"):
        fft2_sharded(
            np.ones((64, 64), np.float32),
            mesh8,
            sp_axis="dp",
            imag=np.ones((64, 32), np.float32),
        )


def test_fftn_sharded_slab_matches_oracle(mesh8, rng):
    from gpu_fft_tpu.parallel import fftn_sharded, ifftn_sharded

    x = rng.standard_normal((16, 32, 64)).astype(np.float32)
    yr, yi = fftn_sharded(x, mesh8, sp_axis="dp")
    ref = np.fft.fftn(x.astype(np.float64))
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr) - ref.real).max() / scale < 3e-5
    assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 3e-5
    br, bi = ifftn_sharded(yr, yi, mesh8, sp_axis="dp")
    assert np.abs(np.asarray(br) - x).max() < 1e-4
    assert np.abs(np.asarray(bi)).max() < 1e-4
    # result keeps the slab sharding (no silent gather)
    assert yr.sharding.spec[0] == "dp"


def test_fftn_sharded_complex_input(mesh8, rng):
    from gpu_fft_tpu.parallel import fftn_sharded

    x = rng.standard_normal((8, 16, 32)).astype(np.float32)
    z = rng.standard_normal((8, 16, 32)).astype(np.float32)
    yr, yi = fftn_sharded(x, mesh8, sp_axis="dp", imag=z)
    ref = np.fft.fftn((x + 1j * z).astype(np.complex128))
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr) - ref.real).max() / scale < 3e-5
    assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 3e-5


def test_fftn_sharded_contracts(mesh8):
    from gpu_fft_tpu.parallel import fftn_sharded

    with pytest.raises(ValueError, match="volume"):
        fftn_sharded(np.ones((8, 8), np.float32), mesh8, sp_axis="dp")
    with pytest.raises(ValueError, match="power-of-two D"):
        fftn_sharded(np.ones((24, 16, 16), np.float32), mesh8, sp_axis="dp")
    with pytest.raises(ValueError, match="divide"):
        fftn_sharded(np.ones((16, 4, 16), np.float32), mesh8, sp_axis="dp")


def test_lfilter_sharded_matches_scipy(mesh8, rng):
    import scipy.signal as ss

    from gpu_fft_tpu.parallel import lfilter_sharded

    b, a = ss.butter(4, 0.15)
    x = rng.standard_normal(65536).astype(np.float32)
    got = np.asarray(lfilter_sharded(b, a, x, mesh8, "dp"))
    ref = ss.lfilter(b, a, x.astype(np.float64))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 5e-5  # the sharded carry is exact math


def test_lfilter_sharded_fir_and_contracts(mesh8, rng):
    from gpu_fft_tpu.parallel import lfilter_sharded

    x = rng.standard_normal(4096).astype(np.float32)
    got = np.asarray(lfilter_sharded([2.0], [1.0], x, mesh8, "dp"))  # k=0 path
    assert np.abs(got - 2.0 * x).max() < 1e-6
    with pytest.raises(ValueError):  # length not divisible over devices
        lfilter_sharded([1.0, 0.5], [1.0], np.ones(1001, np.float32), mesh8, "dp")
    with pytest.raises(ValueError):  # 2-D input
        lfilter_sharded([1.0, 0.5], [1.0], np.ones((2, 8), np.float32), mesh8, "dp")
