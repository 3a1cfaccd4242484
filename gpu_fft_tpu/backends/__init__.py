"""Runtime backend selection.

Mirrors the reference's two-level backend system (reference ``src/lib.rs:20-98``):
a ``Backend`` enum dispatched at runtime, with availability gating replacing
Cargo feature flags.

* ``PALLAS`` — this library's own matmul transform engine (the analog of the
  reference's CubeCL/wgpu default runtime, ``src/lib.rs:113-117``).
* ``XLA``    — the vendor-provided FFT (``jnp.fft``), the analog of the
  reference's MLX backend: same API semantics through a platform library
  (``src/mlx/fft.rs:6-81``).  Also the numerical oracle for the parity suite
  (the ``tests/parity.rs`` pattern).
* ``NATIVE`` — C++ CPU backend behind a C ABI loaded via ctypes, the analog of
  the reference's C FFI shim (``ffi/mlx_fft.c``); present only when the shared
  library has been built (feature-gating analog).
"""

from __future__ import annotations

import enum

from ..config import env_backend_name

__all__ = ["Backend", "available_backends", "default_backend", "resolve_backend"]


class Backend(enum.Enum):
    PALLAS = "pallas"
    XLA = "xla"
    NATIVE = "native"


def available_backends() -> list[Backend]:
    """All backends usable in this process (reference ``src/lib.rs:57-66``)."""
    backends = [Backend.PALLAS, Backend.XLA]
    from . import native  # deferred: probes for the shared library

    if native.is_available():
        backends.append(Backend.NATIVE)
    return backends


def default_backend() -> Backend:
    """The library's own kernels, unless overridden via GPU_FFT_TPU_BACKEND."""
    name = env_backend_name()
    if name:
        return Backend(name)
    return Backend.PALLAS


def resolve_backend(backend) -> Backend:
    if backend is None:
        return default_backend()
    if isinstance(backend, Backend):
        return backend
    return Backend(str(backend).lower())
