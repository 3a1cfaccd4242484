"""Global constants and environment plumbing.

Mirrors the role of the reference's compile-time constants
(``WORKGROUP_SIZE``/``TILE_SIZE``/``TILE_BITS``, reference ``src/lib.rs:100-111``).
Here the transform is a chain of dense DFT matmuls, so the constants that
matter are the size bands of the three transform engines and the precision
of those matmuls.
"""

from __future__ import annotations

import os

# ── Transform planning thresholds ────────────────────────────────────────────
# DIRECT_MAX: largest transform computed as a single DFT matrix multiply
#   X = x @ F_n (one matmul over the whole batch of rows); the tables cost
#   2 * n^2 * 4 bytes, 2 MiB at 512.
DIRECT_MAX = 512

# FUSED_MAX: largest transform run as one four-step einsum graph (reshape to
# (n1, n2), DFT columns, twiddle, DFT rows — kernels/fused_jnp.py), the
# analog of the reference's single-dispatch fused inner kernel
# (``butterfly_inner``, reference ``src/butterfly.rs:84-147``).
FUSED_MAX = 65536

# Maximum supported transform length.  Above FUSED_MAX the transform is
# factored recursively at the JAX level (kernels/large.py); two balanced
# levels cover up to FUSED_MAX**2.
MAX_N = 1 << 24

# ── Matmul precision mode ────────────────────────────────────────────────────
# Every DFT matmul on the transform path names its precision from this mode
# (an f32 dot that names none may run in TF32 on the GPU):
#   "full"  (default) — lax.Precision.HIGHEST: fp32 outside the tensor
#                       cores; the mode that meets the reference's
#                       5*log2(N)*eps roundtrip gate.
#   "high"  — lax.Precision.HIGH.
#   "fast"  — lax.Precision.DEFAULT.
# What "high" and "fast" lower to on the H100, with their errors and times,
# is recorded in PERF.md.  Process-level: set GPU_FFT_TPU_PRECISION before
# the first transform (jit caches trace the mode in).
PRECISION = os.environ.get("GPU_FFT_TPU_PRECISION", "full").strip().lower()
if PRECISION not in ("full", "high", "fast"):
    raise ValueError(
        f"GPU_FFT_TPU_PRECISION must be one of full|high|fast, got {PRECISION!r}"
    )


def matmul_precision():
    """The jax.lax.Precision for the current mode (trace-time lookup)."""
    from jax import lax

    return {
        "full": lax.Precision.HIGHEST,
        "high": lax.Precision.HIGH,
        "fast": lax.Precision.DEFAULT,
    }[PRECISION]


# Use the Gauss/Karatsuba 3-multiplication complex matmul instead of the
# 4-multiplication form: 25% fewer matmul FLOPs; the extra additions
# introduce a small, bounded cancellation error, validated against the
# 5*log2(N)*eps roundtrip gate.
KARATSUBA = True

# Fallback compile-cache directory: fixed inside the checkout, because the
# path is part of the cache key (a directory that moves never hits).
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache for this process.

    The analog of CubeCL's documented shader-cache warm-up effect (reference
    ``README.md:87-89``), made persistent: later processes reuse compiled
    executables.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
    itself and no directory is set here; otherwise the cache lives at
    :data:`CACHE_DIR`.  Called by the CLI, ``bench.py`` and
    ``chip_smoke.py``.  Returns the directory in use.
    """
    import jax

    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = CACHE_DIR
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return d


# ── Environment ──────────────────────────────────────────────────────────────
# Default backend override, mirroring the reference's feature-flag default
# runtime selection (reference ``src/lib.rs:113-117``).
BACKEND_ENV_VAR = "GPU_FFT_TPU_BACKEND"

# Path override for the native C++ backend shared library (the analog of the
# reference's ``MLX_C_PREFIX`` build-time env var, reference ``build.rs:10``).
NATIVE_LIB_ENV_VAR = "GPU_FFT_TPU_NATIVE_LIB"


def env_backend_name() -> str | None:
    """Return the backend name requested via environment, or None."""
    v = os.environ.get(BACKEND_ENV_VAR)
    return v.strip().lower() if v else None
