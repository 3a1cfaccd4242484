"""Cross-validation of the staged-path stages against independent oracles.

Every stage is plain jnp: stage A (column DFT + twiddle,
kernels/fused_jnp.py:stage_a_jnp) and stage B (row transforms with the
digit reversal folded into the last einsum).  These tests pin each stage
to float64 numpy so the composition can never silently drift.
"""

import numpy as np
import pytest
from conftest import assert_slice_approx

from gpu_fft_tpu.kernels.fused_jnp import stage_a_jnp, stage_b_jnp
from gpu_fft_tpu.kernels.large import transform_any
from gpu_fft_tpu.plan import get_stage_a_plan


@pytest.mark.parametrize("cols", [None, 1024])
@pytest.mark.parametrize("rows", [None, 65])
def test_stage_a_matches_float64(rng, rows, cols):
    # Stage A with the row/column limits the staged real paths use
    # (kernels/large.py:_stage_a) against the explicit column DFT and
    # twiddle in float64.
    import jax.numpy as jnp

    from gpu_fft_tpu.kernels.large import _stage_a

    n = 1 << 17
    plan = get_stage_a_plan(n, -1)
    n1, n2 = plan["n1"], plan["n2"]
    xr = rng.uniform(-1.0, 1.0, (2, n1, n2)).astype(np.float32)
    xi = rng.uniform(-1.0, 1.0, (2, n1, n2)).astype(np.float32)
    yr, yi = _stage_a(jnp.asarray(xr), jnp.asarray(xi), plan, rows=rows, cols=cols)
    f1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)
    ref = np.einsum("ka,bac->bkc", f1, xr + 1j * xi.astype(np.float64)) * tw[None]
    ref = ref[:, : rows or n1, : cols or n2]
    assert yr.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr) - ref.real).max() / scale < 5 * np.log2(n) * 2**-23
    assert np.abs(np.asarray(yi) - ref.imag).max() / scale < 5 * np.log2(n) * 2**-23


def test_stage_b_jnp_matches_rows_plus_transpose(rng):
    import jax.numpy as jnp

    n = 1 << 17
    plan = get_stage_a_plan(n, -1)
    n1, n2 = plan["n1"], plan["n2"]
    sb = plan["stage_b"]
    assert sb is not None, "2^17 plan must carry stage-B tables"
    xr = jnp.asarray(rng.uniform(-1.0, 1.0, (2, n1, n2)).astype(np.float32))
    xi = jnp.asarray(rng.uniform(-1.0, 1.0, (2, n1, n2)).astype(np.float32))
    kr, ki = stage_b_jnp(xr, xi, n1, n2, sb)
    # Oracle: numpy row FFTs + explicit digit-reversal transpose.
    z = np.asarray(xr).astype(np.complex128) + 1j * np.asarray(xi)
    ref = np.swapaxes(np.fft.fft(z, axis=-1), 1, 2).reshape(2, n)
    assert_slice_approx(np.asarray(kr), ref.real.astype(np.float32),
                        eps=1e-2, label="stage_b re")
    assert_slice_approx(np.asarray(ki), ref.imag.astype(np.float32),
                        eps=1e-2, label="stage_b im")


@pytest.mark.parametrize("n", [1 << 17, 1 << 19])
def test_staged_path_vs_oracle(rng, n):
    # Full staged dispatch (einsum stage A + folded-einsum stage B) against
    # numpy, forward and inverse.
    import jax.numpy as jnp

    x = jnp.asarray(rng.uniform(-1.0, 1.0, (1, n)).astype(np.float32))
    yr, yi = transform_any(x, None, n, -1)
    ref = np.fft.fft(np.asarray(x[0]).astype(np.complex128))
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(yr[0]) - ref.real).max() / scale < 1e-5
    assert np.abs(np.asarray(yi[0]) - ref.imag).max() / scale < 1e-5
    rr, ri = transform_any(yr, yi, n, +1)
    assert np.abs(np.asarray(rr[0]) / n - np.asarray(x[0])).max() < 1e-4


@pytest.mark.parametrize("n", [1024, 4096, 65536])
@pytest.mark.parametrize("complex_input", [False, True])
def test_folded_matches_transpose_form(rng, n, complex_input):
    # Both fused-size layouts (folded output permutation vs explicit
    # transposes) must agree — the dispatch picks by measured speed only.
    import jax.numpy as jnp

    from gpu_fft_tpu.kernels.fused_jnp import fused_fft_jnp, fused_fft_jnp_folded
    from gpu_fft_tpu.plan import get_fused_plan

    xr = jnp.asarray(rng.uniform(-1.0, 1.0, (3, n)).astype(np.float32))
    xi = jnp.asarray(rng.uniform(-1.0, 1.0, (3, n)).astype(np.float32)) if complex_input else None
    plan = get_fused_plan(n, -1)
    ar, ai = fused_fft_jnp(xr, xi, plan)
    br, bi = fused_fft_jnp_folded(xr, xi, plan)
    scale = max(1.0, float(np.abs(np.asarray(ar)).max()))
    assert np.abs(np.asarray(ar) - np.asarray(br)).max() / scale < 1e-6
    assert np.abs(np.asarray(ai) - np.asarray(bi)).max() / scale < 1e-6


def test_fused_sizes_have_no_stage_b(rng):
    # The fused/staged boundary: 2^16 uses the jnp four-step directly.
    import jax.numpy as jnp

    from gpu_fft_tpu.config import FUSED_MAX

    x = jnp.asarray(rng.uniform(-1.0, 1.0, (1, FUSED_MAX)).astype(np.float32))
    yr, _ = transform_any(x, None, FUSED_MAX, -1)
    ref = np.fft.fft(np.asarray(x[0]).astype(np.complex128))
    assert np.abs(np.asarray(yr[0]) - ref.real).max() / np.abs(ref).max() < 1e-5
