"""Precision-mode tests (GPU_FFT_TPU_PRECISION: full | high | fast).

On the CPU mesh the jax Precision flags are no-ops (f32 is computed
exactly), so CPU runs only verify the plumbing and that every mode stays
correct; how the modes trade accuracy on the card is asserted by the
``gpu``-marked test below (bands measured on an H100, PERF.md).
"""

import numpy as np
import pytest

from gpu_fft_tpu import config
from gpu_fft_tpu.kernels.fused_jnp import fused_fft_jnp_folded
from gpu_fft_tpu.plan import get_fused_plan


def _rel_err(mode, monkeypatch, rng, n=16384):
    monkeypatch.setattr(config, "PRECISION", mode)
    x = rng.uniform(-1.0, 1.0, (1, n)).astype(np.float32)
    import jax.numpy as jnp

    yr, yi = fused_fft_jnp_folded(jnp.asarray(x), None, get_fused_plan(n, -1))
    ref = np.fft.fft(x[0].astype(np.float64))
    scale = np.abs(ref).max()
    return max(
        float(np.abs(np.asarray(yr[0]) - ref.real).max()),
        float(np.abs(np.asarray(yi[0]) - ref.imag).max()),
    ) / float(scale)


@pytest.mark.parametrize("mode,band", [("full", 1e-6), ("high", 2e-4), ("fast", 2e-2)])
def test_modes_stay_within_band(mode, band, monkeypatch, rng):
    assert _rel_err(mode, monkeypatch, rng) < band


def test_full_meets_gate(monkeypatch, rng):
    assert _rel_err("full", monkeypatch, rng) < 1e-6  # every platform


@pytest.mark.gpu
def test_modes_trade_accuracy_on_card(gpu, monkeypatch, rng):
    # On the GPU, HIGHEST is fp32 while HIGH and DEFAULT run the matmuls in
    # TF32 (~5e-4 relative error measured on an H100, PERF.md): the two
    # reduced modes coincide in accuracy and both miss the gate.
    e_full = _rel_err("full", monkeypatch, rng)
    e_high = _rel_err("high", monkeypatch, rng)
    e_fast = _rel_err("fast", monkeypatch, rng)
    assert e_full < 1e-6
    assert 1e-4 < e_high < 2e-3
    assert 1e-4 < e_fast < 2e-3


def test_invalid_mode_rejected(monkeypatch):
    monkeypatch.setattr(config, "PRECISION", "bogus")
    with pytest.raises(KeyError):
        config.matmul_precision()
