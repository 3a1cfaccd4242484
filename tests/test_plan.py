"""Planning-layer unit tests: factorization, tables, caching."""

import numpy as np
import pytest

from gpu_fft_tpu.config import DIRECT_MAX, FUSED_MAX
from gpu_fft_tpu.kernels.tables import dft_matrix, twiddle_table
from gpu_fft_tpu.ops.transform import next_power_of_two
from gpu_fft_tpu.plan import (
    balanced_split,
    get_fused_plan,
    get_stage_a_plan,
    stage_b_plannable,
)


def test_next_power_of_two():
    # Rust usize::next_power_of_two semantics.
    assert next_power_of_two(0) == 1
    assert next_power_of_two(1) == 1
    assert next_power_of_two(2) == 2
    assert next_power_of_two(3) == 4
    assert next_power_of_two(1000) == 1024
    assert next_power_of_two(1024) == 1024
    assert next_power_of_two(1025) == 2048


def test_balanced_split():
    for n in [4, 64, 1024, 4096, 65536, 1 << 20]:
        n1, n2 = balanced_split(n)
        assert n1 * n2 == n
        assert n1 <= n2 <= 2 * n1
    with pytest.raises(ValueError):
        balanced_split(100)


def test_dft_matrix_is_unitary_up_to_n():
    # F(sign=-1) @ F(sign=+1) == n * I.
    n = 64
    fr, fi = dft_matrix(n, -1)
    gr, gi = dft_matrix(n, +1)
    f = fr.astype(np.float64) + 1j * fi
    g = gr.astype(np.float64) + 1j * gi
    prod = f @ g
    assert np.abs(prod - n * np.eye(n)).max() < 1e-3


def test_twiddle_matches_direct_exp():
    t_r, t_i = twiddle_table(8, 16, 128, -1)
    a, b = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    ref = np.exp(-2j * np.pi * a * b / 128)
    assert np.abs(t_r - ref.real).max() < 1e-6
    assert np.abs(t_i - ref.imag).max() < 1e-6


def test_plan_kinds():
    assert get_fused_plan(DIRECT_MAX, -1).kind == "direct"
    assert get_fused_plan(DIRECT_MAX * 2, -1).kind == "fourstep"
    assert get_fused_plan(FUSED_MAX, -1).kind == "fourstep"
    with pytest.raises(ValueError):
        get_fused_plan(FUSED_MAX * 2, -1)
    with pytest.raises(ValueError):
        get_fused_plan(100, -1)
    with pytest.raises(ValueError):
        get_fused_plan(64, 2)


def test_plan_cached():
    assert get_fused_plan(256, -1) is get_fused_plan(256, -1)


def test_stage_a_plan_digits():
    # n1 = 128 (tuning.stage_a_n1) at every staged size until n2 would
    # exceed FUSED_MAX.
    for n, want_n1 in ((1 << 17, 128), (1 << 20, 128), (1 << 23, 128), (1 << 24, 256)):
        p = get_stage_a_plan(n, -1)
        assert p["n1"] == want_n1, n
        assert p["n1"] * p["n2"] == n
        assert p["n2"] <= FUSED_MAX
    with pytest.raises(ValueError):
        get_stage_a_plan(FUSED_MAX, -1)  # fused sizes have no staged plan


def test_stage_b_plannable_band():
    # The folded-digit-reversal stage B needs the full-lane m2 = 128 split.
    assert stage_b_plannable(1024)
    assert stage_b_plannable(65536)
    assert not stage_b_plannable(192)  # not a multiple of 128
    assert not stage_b_plannable(128)  # too small to split as (m1, 128)
    # Every production staged plan carries stage-B tables.
    for n in (1 << 17, 1 << 19, 1 << 22):
        sb = get_stage_a_plan(n, -1)["stage_b"]
        assert sb is not None and sb["m2"] == 128
        assert sb["m1"] * sb["m2"] == get_stage_a_plan(n, -1)["n2"]


def test_device_api_rejects_native_backend():
    import numpy as np
    import pytest as _pytest

    from gpu_fft_tpu import Backend, fft_device, ifft_device

    x = np.zeros(16, np.float32)
    with _pytest.raises(ValueError):
        fft_device(x, backend=Backend.NATIVE)
    with _pytest.raises(ValueError):
        ifft_device(x, x, backend=Backend.NATIVE)


def test_ifft_device_rejects_mismatched_shapes():
    import numpy as np
    import pytest as _pytest

    from gpu_fft_tpu import ifft_device

    with _pytest.raises(ValueError):
        ifft_device(np.zeros(8, np.float32), np.zeros((2, 8), np.float32))


def test_warmup():
    import pytest as _pytest

    import gpu_fft_tpu as gf

    gf.warmup(sizes=(64,), batches=(1, 2))
    with _pytest.raises(ValueError):
        gf.warmup(sizes=(100,))


def test_describe_plan_dispatch_map():
    from gpu_fft_tpu.plan import describe_plan

    assert describe_plan(512)["path"] == "direct"
    p = describe_plan(4096, batch=64)
    assert p["path"] == "fourstep" and p["wide"] and p["split"] == (32, 128)
    assert p["layout"] == "folded"
    # Real input at n >= half_spectrum_min takes the Hermitian half path.
    assert describe_plan(65536, batch=1)["layout"] == "half-spectrum"
    assert describe_plan(65536, batch=1, real_input=False)["layout"] == "transpose"
    assert describe_plan(65536, batch=2, real_input=False)["layout"] == "folded"
    assert describe_plan(16384, batch=1)["layout"] == "folded"
    s = describe_plan(1 << 20)
    assert s["path"] == "staged" and s["split"] == (128, 8192)
    assert s["layout"] == "half-spectrum"
    assert describe_plan(1 << 20, real_input=False)["layout"] == "folded"
    assert s["stage_b_split"] == (64, 128)
    with pytest.raises(ValueError):
        describe_plan(100)


# ── Per-device tuning table ──────────────────────────────────────────────────


def test_tuning_table_is_consulted(monkeypatch):
    # The dispatch predicates must read the per-device table, not baked-in
    # constants: overriding the selected row changes every decision.
    from dataclasses import replace

    from gpu_fft_tpu import tuning
    from gpu_fft_tpu.ops.filter import _best_block_fft_size
    from gpu_fft_tpu.plan import (
        _stage_a_n1,
        half_spectrum_applies,
        use_folded_layout,
        wide_split_applies,
    )

    base = tuning.TUNING["h100"]
    assert wide_split_applies(64, 4096) and not wide_split_applies(4, 4096)
    assert use_folded_layout(1, 4096) and not use_folded_layout(1, 65536)
    assert _stage_a_n1(1 << 20) == 128
    assert _best_block_fft_size(33) == 16384
    assert half_spectrum_applies(1 << 15) and not half_spectrum_applies(1 << 14)

    mod = replace(
        base,
        name="test",
        wide_batch_min=2,
        folded_n_max=65536,
        stage_a_n1=256,
        oa_block_min=4096,
        half_spectrum_min=1 << 62,
        calibrated=False,
        note="test row",
    )
    monkeypatch.setitem(tuning.TUNING, "test", mod)
    monkeypatch.setenv("GPU_FFT_TPU_CHIP", "test")
    assert wide_split_applies(4, 4096)  # batch_min now 2
    assert use_folded_layout(1, 65536)  # folded_n_max now 65536
    assert _stage_a_n1(1 << 20) == 256
    assert _best_block_fft_size(33) == 4096
    assert not half_spectrum_applies(1 << 20)  # gate now off everywhere


def test_tuning_every_chip_has_a_row():
    from gpu_fft_tpu.tuning import TUNING
    from gpu_fft_tpu.utils.roofline import CHIPS

    for name in CHIPS:
        assert name in TUNING, f"no tuning row for chip {name}"
    # No row was measured on its device yet; the CPU mesh mirrors the GPU.
    assert not TUNING["h100"].calibrated
    from dataclasses import replace

    assert replace(TUNING["cpu"], name="h100", note=TUNING["h100"].note) == TUNING["h100"]


def test_tuning_unknown_chip_env_rejected(monkeypatch):
    import pytest as _pytest

    from gpu_fft_tpu.tuning import get_tuning

    monkeypatch.setenv("GPU_FFT_TPU_CHIP", "a100")
    with _pytest.raises(ValueError):
        get_tuning()


def test_detected_tuning_raises_on_unknown_device(monkeypatch):
    # No silent default: a device without a table row is an error.
    from gpu_fft_tpu import tuning
    from gpu_fft_tpu.utils import roofline

    def unknown():
        raise ValueError("no device-table row for platform='gpu' device_kind='X'")

    monkeypatch.delenv("GPU_FFT_TPU_CHIP", raising=False)
    monkeypatch.setattr(roofline, "device_key", unknown)
    tuning._detected_tuning.cache_clear()
    try:
        with pytest.raises(ValueError, match="no device-table row"):
            tuning.get_tuning()
    finally:
        tuning._detected_tuning.cache_clear()
