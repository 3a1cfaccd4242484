"""Hermitian half-spectrum real-input path (tuning.half_spectrum_min).

Real input makes the spectrum Hermitian (X[n-k] = conj(X[k]), either sign),
so the dispatch computes only the k1 <= n1/2 half after the twiddle and
mirrors the rest (kernels/fused_jnp.py: fused_fft_jnp_half /
stage_b_half_jnp / _hermitian_mirror).  These tests pin the mirror math
against numpy f64 at fused and staged sizes, both signs, odd batches, and
assert the gate routes exactly where the tuning table says.
"""

import numpy as np
import pytest

import jax.numpy as jnp


def _err(yr, yi, ref):
    nrm = np.abs(ref).max()
    return max(
        np.abs(np.asarray(yr, np.float64) - ref.real).max(),
        np.abs(np.asarray(yi, np.float64) - ref.imag).max(),
    ) / nrm


def _bound(n):
    return 5 * np.log2(n) * np.finfo(np.float32).eps


@pytest.mark.parametrize(
    "b,n",
    [
        (1, 1 << 15),  # smallest gated fused size
        (3, 1 << 16),  # odd batch, top fused size
        (1, 1 << 17),  # smallest staged size
        (2, 1 << 18),  # staged, batch
    ],
)
@pytest.mark.parametrize("sign", [-1, 1])
def test_half_spectrum_matches_numpy(b, n, sign):
    from gpu_fft_tpu.kernels.large import transform_any
    from gpu_fft_tpu.plan import half_spectrum_applies

    assert half_spectrum_applies(n)
    rng = np.random.default_rng(n + b + sign)
    x = rng.standard_normal((b, n)).astype(np.float32)
    yr, yi = transform_any(jnp.asarray(x), None, n, sign)
    ref = np.fft.fft(x.astype(np.float64), axis=1)
    if sign == 1:
        ref = np.conj(ref)
    assert _err(yr, yi, ref) < _bound(n), f"b={b} n={n} sign={sign}"


def test_half_spectrum_scale_folds():
    # scale (the normalized inverse's 1/n) must fold into the half path's
    # final tables exactly like the full-spectrum forms.
    from gpu_fft_tpu.kernels.large import transform_any

    n = 1 << 15
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, n)).astype(np.float32)
    yr, yi = transform_any(jnp.asarray(x), None, n, 1, scale=1.0 / n)
    ref = np.conj(np.fft.fft(x.astype(np.float64), axis=1)) / n
    assert _err(yr, yi, ref) < _bound(n)


def test_half_functions_agree_with_full():
    # The half-path kernels must reproduce the full-spectrum engines bit-close
    # (same tables, same contraction order up to the mirrored half).
    from gpu_fft_tpu.kernels.fused_jnp import (
        fused_fft_jnp,
        fused_fft_jnp_half,
        stage_b_half_jnp,
        stage_b_jnp,
        stage_a_jnp,
    )
    from gpu_fft_tpu.plan import get_fused_plan, get_stage_a_plan

    rng = np.random.default_rng(9)
    n = 1 << 15
    x = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32))
    plan = get_fused_plan(n, -1, wide=False)
    fr, fi = fused_fft_jnp(x, None, plan)
    hr, hi = fused_fft_jnp_half(x, plan)
    np.testing.assert_allclose(np.asarray(hr), np.asarray(fr), atol=2e-3)
    np.testing.assert_allclose(np.asarray(hi), np.asarray(fi), atol=2e-3)

    n = 1 << 17
    sp = get_stage_a_plan(n, -1)
    n1, n2 = sp["n1"], sp["n2"]
    x = jnp.asarray(rng.standard_normal((1, n)).astype(np.float32))
    yr, yi = stage_a_jnp(x.reshape(1, n1, n2), None, sp)
    fr, fi = stage_b_jnp(yr, yi, n1, n2, sp["stage_b"])
    hr, hi = stage_b_half_jnp(yr, yi, n1, n2, sp["stage_b"])
    np.testing.assert_allclose(np.asarray(hr), np.asarray(fr), atol=2e-2)
    np.testing.assert_allclose(np.asarray(hi), np.asarray(fi), atol=2e-2)


def test_gate_off_routes_full_spectrum(monkeypatch):
    # With the gate forced off, real input at a gated size must give the
    # same answer through the full-spectrum layouts (dispatch equivalence).
    from dataclasses import replace

    from gpu_fft_tpu import tuning
    from gpu_fft_tpu.kernels.large import transform_any
    from gpu_fft_tpu.plan import half_spectrum_applies

    n = 1 << 15
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, n)).astype(np.float32)
    on_r, on_i = transform_any(jnp.asarray(x), None, n, -1)

    mod = replace(tuning.TUNING["h100"], name="test", half_spectrum_min=1 << 62)
    monkeypatch.setitem(tuning.TUNING, "test", mod)
    monkeypatch.setenv("GPU_FFT_TPU_CHIP", "test")
    assert not half_spectrum_applies(n)
    off_r, off_i = transform_any(jnp.asarray(x), None, n, -1)
    np.testing.assert_allclose(np.asarray(on_r), np.asarray(off_r), atol=2e-3)
    np.testing.assert_allclose(np.asarray(on_i), np.asarray(off_i), atol=2e-3)


def test_hermitian_mirror_unit():
    # Mirror identity on a directly-computed half spectrum: build the full
    # spectrum of random real input, slice the (b, n1, n2) k1-major view to
    # h rows, mirror, compare — pins the digit-reversal/reversal math
    # independent of the matmul engines.
    from gpu_fft_tpu.kernels.fused_jnp import _hermitian_mirror

    rng = np.random.default_rng(11)
    b, n1, n2 = 2, 8, 16
    n = n1 * n2
    x = rng.standard_normal((b, n))
    full = np.fft.fft(x, axis=1)  # X[k], k = k1 + n1*j
    # k1-major view: axis 1 = k1, axis 2 = j.
    v = np.transpose(full.reshape(b, n2, n1), (0, 2, 1))
    h = n1 // 2 + 1
    sr = jnp.asarray(v.real[:, :h, :], jnp.float32)
    si = jnp.asarray(v.imag[:, :h, :], jnp.float32)
    fr, fi = _hermitian_mirror(sr, si, n1, axis=1)
    np.testing.assert_allclose(np.asarray(fr), v.real, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(fi), v.imag, atol=1e-4, rtol=1e-4)
