"""Exact non-power-of-two FFT (Bluestein) tests — oracle: numpy.fft."""

import numpy as np
import pytest

import gpu_fft_tpu as gf


@pytest.mark.parametrize("n", [3, 12, 100, 997, 1000, 1536, 48000])
def test_fft_exact_matches_numpy(rng, n):
    x = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    re, im = gf.fft_exact(x)
    ref = np.fft.fft(x.astype(np.float64))
    scale = max(1.0, float(np.abs(ref).max()))
    assert re.shape == (n,)
    assert np.abs(re - ref.real).max() / scale < 2e-5, f"n={n}"
    assert np.abs(im - ref.imag).max() / scale < 2e-5, f"n={n}"


def test_fft_exact_pow2_dispatch(rng):
    # Power-of-two lengths take the direct path and match fft().
    x = rng.uniform(-1.0, 1.0, 1024).astype(np.float32)
    re, im = gf.fft_exact(x)
    re2, im2 = gf.fft(x)
    scale = max(1.0, float(np.abs(re2).max()))
    assert np.abs(re - re2).max() / scale < 1e-6
    assert np.abs(im - im2).max() / scale < 1e-6


def test_fft_exact_differs_from_padded(rng):
    # The whole point: padding computes a different spectrum.
    x = rng.uniform(-1.0, 1.0, 1000).astype(np.float32)
    re_exact, _ = gf.fft_exact(x)
    re_padded, _ = gf.fft(x)  # pads to 1024
    assert re_exact.shape == (1000,)
    assert re_padded.shape == (1024,)
    ref = np.fft.fft(x.astype(np.float64))
    assert np.abs(re_exact - ref.real).max() / np.abs(ref).max() < 2e-5


def test_ifft_exact_roundtrip(rng):
    for n in (60, 1000):
        x = rng.uniform(-1.0, 1.0, n).astype(np.float32)
        re, im = gf.fft_exact(x)
        rr, ri = gf.ifft_exact(re, im)
        assert np.abs(rr - x).max() < 1e-4, f"n={n}"
        assert np.abs(ri).max() < 1e-4, f"n={n}"


def test_fft_exact_complex_and_batch(rng):
    xr = rng.uniform(-1.0, 1.0, (3, 250)).astype(np.float32)
    xi = rng.uniform(-1.0, 1.0, (3, 250)).astype(np.float32)
    yr, yi = gf.fft_exact_device(xr, xi)
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64), axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr) - ref.real).max() / scale < 2e-5
    assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 2e-5


def test_fft_exact_n1_and_errors(rng):
    re, im = gf.fft_exact(np.array([3.5], np.float32))
    assert re[0] == pytest.approx(3.5) and im[0] == 0.0
    with pytest.raises(ValueError):
        gf.fft_exact(np.zeros(0, np.float32))
    with pytest.raises(ValueError):
        gf.ifft_exact(np.zeros(8, np.float32), np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        # imag shape must match exactly (no silent broadcasting).
        gf.fft_exact_device(np.zeros((4, 250), np.float32), np.zeros((1, 250), np.float32))


def test_fft_exact_pow2_max_n_not_rejected():
    # The Bluestein 2n-1 bound must not apply to power-of-two lengths (they
    # dispatch straight to the direct path); MAX_N itself is valid.
    from gpu_fft_tpu.config import MAX_N
    from gpu_fft_tpu.ops.exact import _check_exact_n

    _check_exact_n(MAX_N)  # must not raise
    with pytest.raises(ValueError):
        _check_exact_n(MAX_N + 1)  # non-pow2 beyond the Bluestein bound
    with pytest.raises(ValueError):
        _check_exact_n(2 * MAX_N)  # pow2 beyond MAX_N


# ── Mixed-radix four-step path (balanced divisor pairings) ───────────────────


def test_mixed_split_selection():
    """Balanced pairings ride the matmul four-step; primes and lopsided
    composites stay on Bluestein; pow2 never enters (the direct path owns
    it).  The gate is modeled FLOPs, so a huge near-balanced semiprime
    (1009 * 997) correctly prefers the chirp path's staged transforms."""
    from gpu_fft_tpu.ops.exact import MIXED_DIGIT_MAX, mixed_split

    assert mixed_split(48000) == (200, 240)
    assert mixed_split(44100) == (210, 210)
    assert mixed_split(6) == (2, 3)
    assert mixed_split(97) is None  # prime
    assert mixed_split(2 * 1009) is None  # lopsided
    assert mixed_split(1 << 12) is None  # pow2: not this path's job
    assert mixed_split(1009 * 997) is None  # FLOPs gate prefers Bluestein
    sp = mixed_split(3 * (1 << 16))
    assert sp is not None and max(sp) <= MIXED_DIGIT_MAX


@pytest.mark.parametrize("n", [6, 360, 1000, 44100, 48000])
def test_mixed_fft_matches_numpy(rng, n):
    """The mixed four-step is exact at audio-style lengths (real, complex,
    batch)."""
    from gpu_fft_tpu.ops.exact import mixed_split

    assert mixed_split(n) is not None  # pin: these must ride the mixed path
    x = rng.standard_normal((2, n)).astype(np.float32)
    xi = rng.standard_normal((2, n)).astype(np.float32)
    yr, yi = gf.fft_exact_device(x, xi)
    ref = np.fft.fft((x + 1j * xi).astype(np.complex128), axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr) - ref.real).max() / scale < 5e-6
    assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 5e-6
    br, bi = gf.ifft_exact_device(yr, yi)
    assert np.abs(np.asarray(br) - x).max() < 5e-4
    assert np.abs(np.asarray(bi) - xi).max() < 5e-4


def test_mixed_roofline_kind_mirrors_dispatch():
    """The fft_exact roofline charge follows the live selection: matmul
    stages for a mixed length, two pow2 transforms for a Bluestein one."""
    from gpu_fft_tpu.utils.roofline import transform_cost

    mixed = transform_cost(1, 48000, "fft_exact")
    assert len(mixed["stages"]) == 2
    assert {k for _, k in mixed["stages"]} == {200, 240}
    blue = transform_cost(1, 65537, "fft_exact")  # prime: chirp path
    assert len(blue["stages"]) > 2  # two pow2 transforms' stage lists
    assert blue["flops"] > mixed["flops"] * 3
