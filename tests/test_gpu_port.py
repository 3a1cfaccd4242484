"""The transform path as it runs on the GPU: plain jnp engines, the device
table, the compile cache, and the smoke script's failure modes.

The band 1024 <= n <= 16384 at small batch is checked against float64 numpy
through ``transform_any`` (the path every fused-size call takes), the linear
maps' transposes against the dot-product identity, and the package against
TPU-only imports.  The card itself is exercised by ``chip_smoke.py``; the one
test here that needs it carries the ``gpu`` marker and skips elsewhere.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
EPS32 = float(np.finfo(np.float32).eps)


def _gate(n):
    return 5.0 * np.log2(n) * EPS32


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192, 16384])
def test_real_forward_matches_float64(b, n):
    import jax.numpy as jnp

    from gpu_fft_tpu.kernels.large import transform_any

    x = np.random.default_rng(n + b).uniform(-1, 1, (b, n)).astype(np.float32)
    yr, yi = transform_any(jnp.asarray(x), None, n, -1)
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    err = max(np.abs(np.asarray(yr) - ref.real).max(), np.abs(np.asarray(yi) - ref.imag).max())
    assert err / np.abs(ref).max() <= _gate(n)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192, 16384])
def test_scaled_complex_inverse_matches_float64(b, n):
    import jax.numpy as jnp

    from gpu_fft_tpu.kernels.large import transform_any

    rng = np.random.default_rng(7 * n + b)
    xr = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    xi = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    yr, yi = transform_any(jnp.asarray(xr), jnp.asarray(xi), n, +1, scale=1.0 / n)
    ref = np.fft.ifft(xr.astype(np.float64) + 1j * xi.astype(np.float64), axis=-1)
    err = max(np.abs(np.asarray(yr) - ref.real).max(), np.abs(np.asarray(yi) - ref.imag).max())
    assert err / np.abs(ref).max() <= _gate(n)


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("n", [4096, 16384])
def test_vjp_dot_product_identity(n, real):
    # <T x, c> == <x, T^T c> for the real form of the transform: the
    # reverse-mode rule is the transpose of the forward map.
    import jax
    import jax.numpy as jnp

    from gpu_fft_tpu.kernels.large import transform_any

    rng = np.random.default_rng(n)
    xr = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32))
    xi = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32))
    cr = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32))
    ci = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32))
    if real:
        (yr, yi), vjp = jax.vjp(lambda v: transform_any(v, None, n, -1), xr)
        (gr,) = vjp((cr, ci))
        lhs = jnp.sum(yr * cr + yi * ci)
        rhs = jnp.sum(xr * gr)
    else:
        (yr, yi), vjp = jax.vjp(lambda a, c: transform_any(a, c, n, -1), xr, xi)
        gr, gi = vjp((cr, ci))
        lhs = jnp.sum(yr * cr + yi * ci)
        rhs = jnp.sum(xr * gr + xi * gi)
    scale = float(jnp.sqrt(jnp.sum(yr * yr + yi * yi) * jnp.sum(cr * cr + ci * ci)))
    assert abs(float(lhs) - float(rhs)) <= _gate(n) * scale


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    # With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and
    # enable_compilation_cache sets no directory in code.
    import jax

    from gpu_fft_tpu import config

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    assert config.enable_compilation_cache() == str(tmp_path / "cache")
    assert "jax_compilation_cache_dir" not in [k for k, _ in calls]


def test_compile_cache_fallback_is_fixed_inside_checkout(monkeypatch):
    import jax

    from gpu_fft_tpu import config

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = config.enable_compilation_cache()
    assert d == str(ROOT / ".jax_cache") == config.CACHE_DIR
    assert ("jax_compilation_cache_dir", d) in calls
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_no_tpu_only_imports_or_platform_interpret():
    # Nothing in the package imports the TPU Pallas dialect, and no kernel
    # picks interpret mode from the platform it finds.
    for path in sorted((ROOT / "gpu_fft_tpu").rglob("*.py")):
        _check_source(path)


def _check_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            parts = (node.module or "").split(".")
            names = {a.name for a in node.names}
            pallas = ["jax", "experimental", "pallas"]
            assert parts[:4] != pallas + ["tpu"], path
            assert not (parts == pallas and "tpu" in names), path
        if isinstance(node, ast.keyword) and node.arg == "interpret":
            src = ast.unparse(node.value)
            assert "backend" not in src and "platform" not in src, (path, src)


def test_transform_path_dots_name_their_precision():
    # An f32 dot that names no precision may run in TF32 on the GPU, so
    # every jnp/lax contraction on the transform path names one.
    paths = sorted((ROOT / "gpu_fft_tpu" / "kernels").glob("*.py")) + [
        ROOT / "gpu_fft_tpu" / "ops" / f"{m}.py"
        for m in ("transform", "fft2d", "exact", "spectral", "stft", "dct", "czt")
    ]
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            name = ast.unparse(node.func)
            if name.startswith(("np.", "numpy.")):
                continue
            if name.split(".")[-1] in ("dot", "einsum", "matmul", "dot_general", "tensordot"):
                kws = {k.arg for k in node.keywords}
                assert "precision" in kws, f"{path.name}:{node.lineno} {name}"


def _run_smoke(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_outside_checkout(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    r = _run_smoke(tmp_path, {"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.gpu
def test_staged_transform_on_card_matches_cufft(gpu):
    import jax.numpy as jnp

    from gpu_fft_tpu.kernels.large import transform_any

    n = 1 << 20
    x = np.random.default_rng(0).uniform(-1, 1, (2, n)).astype(np.float32)
    yr, yi = transform_any(jnp.asarray(x), None, n, -1)
    c = np.asarray(jnp.fft.fft(jnp.asarray(x).astype(jnp.complex64)))
    err = max(np.abs(np.asarray(yr) - c.real).max(), np.abs(np.asarray(yi) - c.imag).max())
    assert err / np.abs(c).max() <= _gate(n)
