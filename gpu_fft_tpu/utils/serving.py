"""Ahead-of-time export for serving: compile once, ship the artifact.

The reference's serving story is per-variant shader compilation at process
startup (reference ``README.md:87-89`` documents ~50 ms first-run compiles
per kernel variant; ``warmup()`` is this library's direct analog).  This
library goes further: ``jax.export`` traces and lowers a
transform ONCE, serializes the StableHLO artifact to bytes, and a serving
process deserializes and runs it with ZERO retracing — Python-side plan
selection, table generation, and jit tracing all happen at build time, so
the serving binary needs only the artifact and its input arrays.  (XLA
still specializes the deserialized module for the local chip on first call;
that compile is cached like any jit.)

Artifacts are per-(kind, batch, n) and per-platform, mirroring the
reference's per-variant shaders: the measured dispatch predicates
(plan.py, tuning.py) branch on concrete shapes at trace time, which is
exactly what makes the compiled program fast — a shape-generic artifact
would have to forgo the measured plan selection.  Pass several entries in
``platforms`` (e.g. ``("cuda", "cpu")``) to build one artifact that runs on
any of them.

CLI: ``python -m gpu_fft_tpu export --kind fft --batch 16 --n 65536 -o fft.bin``
and ``python -m gpu_fft_tpu serve-check fft.bin``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "EXPORT_KINDS",
    "export_transform",
    "save_transform",
    "load_transform",
    "exported_call",
]


def _builders():
    """kind -> (callable, example_args builder).  Each callable is the
    device-resident transform the bench suite measures (utils/profiling.py
    step builders are chained variants of the same dispatches)."""
    import jax.numpy as jnp

    from ..ops.spectral import power_spectrum_device
    from ..ops.transform import fft_device, ifft_device, irfft_device, rfft_device

    def two(b, n):
        return (jnp.zeros((b, n), jnp.float32), jnp.zeros((b, n), jnp.float32))

    def one(b, n):
        return (jnp.zeros((b, n), jnp.float32),)

    def half(b, n):
        return (
            jnp.zeros((b, n // 2 + 1), jnp.float32),
            jnp.zeros((b, n // 2 + 1), jnp.float32),
        )

    return {
        "fft": (lambda x: fft_device(x), one),
        "ifft": (lambda r, i: ifft_device(r, i), two),
        "rfft": (lambda x: rfft_device(x), one),
        "irfft": (lambda r, i: irfft_device(r, i), half),
        "roundtrip": (lambda x: ifft_device(*fft_device(x))[0], one),
        "psd": (lambda x: power_spectrum_device(x), one),
    }


EXPORT_KINDS = ("fft", "ifft", "rfft", "irfft", "roundtrip", "psd")


def export_transform(kind: str, batch: int, n: int, platforms=None):
    """Trace + lower one (kind, batch, n) transform; returns a
    ``jax.export.Exported``.

    ``platforms``: None (the current default backend) or a tuple of
    lowering platforms (``("cuda",)``, ``("cuda", "cpu")``, ...) for
    artifacts built on one machine and served on another.
    """
    import jax
    from jax import export as jexport

    if kind not in EXPORT_KINDS:
        raise ValueError(f"kind must be one of {EXPORT_KINDS}, got {kind!r}")
    if n < 2 or n & (n - 1):
        raise ValueError(f"export requires power-of-two n >= 2, got {n}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    fn, args_of = _builders()[kind]
    args = args_of(batch, n)
    kwargs = {} if platforms is None else {"platforms": tuple(platforms)}
    return jexport.export(jax.jit(fn), **kwargs)(*args)


def save_transform(path: str, kind: str, batch: int, n: int, platforms=None) -> int:
    """Export and serialize one transform to ``path``; returns byte size."""
    blob = export_transform(kind, batch, n, platforms=platforms).serialize()
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def load_transform(path: str):
    """Deserialize an artifact; returns the ``Exported`` (call via
    :func:`exported_call` or ``.call(*args)``)."""
    from jax import export as jexport

    with open(path, "rb") as f:
        return jexport.deserialize(f.read())


def exported_call(exported, *args):
    """Run a (de)serialized artifact on the current backend and return
    NumPy results — the minimal serving loop body."""
    import jax

    out = exported.call(*[np.asarray(a, dtype=np.float32) for a in args])
    return jax.tree_util.tree_map(np.asarray, out)
