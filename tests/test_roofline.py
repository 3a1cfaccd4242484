"""Roofline accounting tests (utils/roofline.py, SURVEY §5 metrics)."""

import numpy as np
import pytest

from gpu_fft_tpu.utils import roofline


def test_transform_cost_direct_vs_fused():
    # Direct (n <= 512): real input = 2 matmuls of n x n over b rows.
    c = roofline.transform_cost(8, 256, "fft")
    assert c["flops"] == pytest.approx(2 * 2.0 * 8 * 256 * 256)
    assert c["bytes"] == 8 * 256 * 4 * 3
    assert c["stages"] == [(2 * 2.0 * 8 * 256 * 256, 256)]
    # Fused four-step FLOPs scale ~ n*(n1+n2), far below direct's n^2.
    # Real input at n >= half_spectrum_min rides the Hermitian half route:
    # full first stage, second matmul / twiddle / epilogue scaled by
    # h/n1 = (n1/2 + 1)/n1, plus the ~2 flops/elem mirror.
    c2 = roofline.transform_cost(1, 65536, "fft")
    assert c2["flops"] < 2 * 2.0 * 65536 * 65536
    n1, n2 = 256, 256
    frac = (n1 // 2 + 1) / n1
    expected = (
        2 * 2.0 * 65536 * n1
        + 3 * 2.0 * 65536 * n2 * frac
        + (6.0 + 5.0) * 65536 * frac
        + 2.0 * 65536
    )
    assert c2["flops"] == pytest.approx(expected)
    assert [k for _, k in c2["stages"]] == [n1, n2]
    # Below the gate (and for complex input) the full-spectrum model holds.
    cfull = roofline.transform_cost(1, 65536, "ifft")
    assert cfull["stages"][1][0] == pytest.approx(3 * 2.0 * 65536 * n2)
    # (1, 16384): the XLA-scheduled fused model (both stages contract 128;
    # complex twiddle + digit-reversal epilogue).
    c3 = roofline.transform_cost(1, 16384, "fft")
    assert [k for _, k in c3["stages"]] == [128, 128]
    assert c3["flops"] == pytest.approx(
        2 * 2.0 * 16384 * 128 + 3 * 2.0 * 16384 * 128 + (6.0 + 5.0) * 16384
    )
    # Batch scales the same model linearly.
    c4 = roofline.transform_cost(2, 16384, "fft")
    assert [k for _, k in c4["stages"]] == [128, 128]
    assert c4["flops"] == pytest.approx(2 * c3["flops"])


def test_transform_cost_mirrors_packing_gate(monkeypatch):
    # When the (currently disabled) real-input packing gate is on, the cost
    # model mirrors the packed plan: one n/2 complex transform + O(n) elem.
    from gpu_fft_tpu import plan as plan_mod

    monkeypatch.setattr(plan_mod, "rfft_pack_applies", lambda b, n: True)
    c2 = roofline.transform_cost(1, 65536, "fft")
    h, h1, h2 = 32768, 128, 256
    mm = 3 * 2.0 * h * h1 + 3 * 2.0 * h * h2
    expected = mm + (6.0 + 5.0 + 5.0) * h + 8.0 * 65536
    assert c2["flops"] == pytest.approx(expected)
    assert [k for _, k in c2["stages"]] == [h1, h2]


def test_device_table_rows():
    # H100 peaks from NVIDIA's data sheet (dense): fp32 67, TF32 495,
    # bf16 989 TFLOP/s, 3.35 TB/s HBM, 50 MB L2 — with the source named.
    h = roofline.CHIPS["h100"]
    assert (h.fp32_tflops, h.tf32_tflops, h.bf16_tflops) == (67.0, 495.0, 989.0)
    assert h.hbm_gbps == 3350.0 and h.l2_mb == 50.0
    assert "data sheet" in h.source
    # The cpu row is explicit (and says it is not a measurement).
    assert "not a measurement" in roofline.CHIPS["cpu"].source
    assert set(roofline.CHIPS) == {"h100", "cpu"}


def test_large_n_recursion_counts_both_stages():
    c = roofline.transform_cost(1, 1 << 20, "fft")
    assert c["flops"] > roofline.transform_cost(1, 65536, "fft")["flops"]
    assert np.isfinite(c["flops"])


def test_roundtrip_cost_exceeds_forward():
    fwd = roofline.transform_cost(1, 4096, "fft")["flops"]
    rt = roofline.transform_cost(1, 4096, "roundtrip")["flops"]
    assert rt > fwd


def test_roofline_row_fields_and_bounds():
    h100 = roofline.CHIPS["h100"]
    row = roofline.roofline_row(1, 65536, "fft", measured_s=10e-6, chip=h100, precision="full")
    assert row["bound"] in ("compute", "hbm")
    assert row["sol_us"] > 0
    assert row["chip"] == "h100" and row["peak_tflops"] == 67.0
    assert row["pct_sol"] == pytest.approx(100.0 * row["sol_us"] / 10.0)
    cost = roofline.transform_cost(1, 65536, "fft")
    assert row["sol_us"] == pytest.approx(
        1e6 * max(cost["flops"] / 67e12, cost["bytes"] / 3350e9)
    )


def test_roofline_row_peak_follows_precision_mode():
    # "full" divides by the fp32 peak; the TF32 modes by the TF32 peak, so
    # their least time is lower for the same compute-bound config.
    h100 = roofline.CHIPS["h100"]
    full = roofline.roofline_row(16, 65536, "fft", 1e-3, chip=h100, precision="full")
    fast = roofline.roofline_row(16, 65536, "fft", 1e-3, chip=h100, precision="fast")
    assert full["bound"] == "compute"
    assert full["peak_tflops"] == 67.0 and fast["peak_tflops"] == 495.0
    assert fast["sol_us"] < full["sol_us"]


def test_roofline_row_hbm_bound_when_bytes_dominate():
    # A huge batch of tiny direct transforms moves more bytes per FLOP than
    # the card's FLOP/byte ratio at TF32: the HBM wall binds.
    row = roofline.roofline_row(
        1 << 16, 8, "fft", 1e-3, chip=roofline.CHIPS["h100"], precision="fast"
    )
    assert row["bound"] == "hbm"


@pytest.mark.parametrize(
    "platform,kind,key",
    [
        ("gpu", "NVIDIA H100 80GB HBM3", "h100"),
        ("gpu", "NVIDIA H100 PCIe", "h100"),
        ("cpu", "cpu", "cpu"),
    ],
)
def test_chip_key_resolves(platform, kind, key):
    assert roofline.chip_key(platform, kind) == key


@pytest.mark.parametrize(
    "platform,kind", [("gpu", "NVIDIA A100-SXM4-80GB"), ("gpu", ""), ("rocm", "AMD Instinct MI300X")]
)
def test_chip_key_unknown_device_raises(platform, kind):
    with pytest.raises(ValueError, match="no device-table row"):
        roofline.chip_key(platform, kind)


def test_detect_chip_runs():
    chip = roofline.detect_chip()
    assert chip.name == roofline.device_key()
    assert chip.hbm_gbps > 0 and chip.fp32_tflops > 0


def test_kernel_stats_counts_gpu_launches():
    # Fusions, library custom calls (cuBLAS) and fft ops (cuFFT) each
    # count as one launch; operands named "fusion" do not.
    txt = """
  %fusion.1 = f32[8]{0} fusion(f32[8]{0} %p0), kind=kLoop, calls=%fused_computation
  %custom-call.2 = (f32[8,8]{1,0}, s8[4]{0}) custom-call(f32[8,8]{1,0} %a, f32[8,8]{1,0} %b), custom_call_target="__cublas$gemm"
  %fft.3 = c64[8]{0} fft(c64[8]{0} %fusion.1), fft_type=FFT, fft_length={8}
  ROOT %tuple = (c64[8]{0}) tuple(c64[8]{0} %fft.3)
"""
    st = roofline.kernel_stats(txt)
    assert (st["n_fusions"], st["n_custom_calls"], st["n_fft"]) == (1, 1, 1)
    assert st["n_kernels"] == 3
    assert len(st["fingerprint"]) == 16


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        roofline.transform_cost(1, 1024, "nope")


def test_extension_kinds():
    c2 = roofline.transform_cost(256, 512, "fft2")
    assert c2["flops"] > roofline.transform_cost(256, 512, "fft")["flops"]
    ce = roofline.transform_cost(1, 48000, "fft_exact")
    # Bluestein pays two 131072-point complex transforms.
    assert ce["flops"] > 2 * roofline.transform_cost(1, 1 << 17, "fft")["flops"] * 0.5
    assert np.isfinite(ce["flops"]) and ce["bytes"] == 48000 * 4 * 3


def test_filter_kinds():
    oa = roofline.transform_cost(64, 4096, "oaconvolve")
    rt = roofline.transform_cost(64, 4096, "roundtrip")
    assert oa["flops"] > rt["flops"]  # roundtrip + spectrum product
    assert oa["bytes"] == 64 * 4096 * 4 * 2
    c2 = roofline.transform_cost(512, 512, "conv2d")
    f2 = roofline.transform_cost(512, 512, "fft2")
    # One-sided path: fwd rfft2 + inverse ~ 1.2x one full 2-D pass (the
    # row inverse is the direct half-input fold at n <= DIRECT_MAX —
    # two real dots contracting n/2 + 1).
    assert f2["flops"] * 1.1 < c2["flops"] < f2["flops"] * 2.0
