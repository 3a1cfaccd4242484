"""NATIVE backend: C++ Stockham FFT behind a C ABI, loaded via ctypes.

The analog of the reference's MLX FFI shim (``ffi/mlx_fft.c`` + ``build.rs``):
a native-code FFT reached through a C boundary with split-complex f32 buffers
on both sides and integer error codes (``ffi/mlx_fft.c:17,48,62``).  The
library is discovered like the reference's MLX prefix probing
(``build.rs:61-90``): an env var override first, then the in-repo build
location.  When absent the backend is simply unavailable — the runtime analog
of a disabled Cargo feature flag.

Build with ``make -C native`` (see native/fft_kernels.cpp).
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib

import numpy as np

from ..config import NATIVE_LIB_ENV_VAR

__all__ = ["is_available", "forward", "inverse", "lib_path"]

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


def lib_path() -> pathlib.Path | None:
    override = os.environ.get(NATIVE_LIB_ENV_VAR)
    candidates = []
    if override:
        candidates.append(pathlib.Path(override))
    candidates.append(_REPO_ROOT / "native" / "libfftnative.so")
    for c in candidates:
        if c.is_file():
            return c
    return None


@functools.lru_cache(maxsize=1)
def _load():
    path = lib_path()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    fp = ctypes.POINTER(ctypes.c_float)
    # int fftnative_transform(const float* re_in, const float* im_in,
    #                      float* re_out, float* im_out,
    #                      size_t batch, size_t n, int sign)
    lib.fftnative_transform.argtypes = [fp, fp, fp, fp, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int]
    lib.fftnative_transform.restype = ctypes.c_int
    return lib


def is_available() -> bool:
    return _load() is not None


def _run(xr: np.ndarray, xi: np.ndarray, sign: int) -> tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native backend not built — run `make -C native` or set "
            f"{NATIVE_LIB_ENV_VAR} to the shared library path"
        )
    if xr.ndim != 2 or xr.shape != xi.shape:
        raise ValueError(
            f"native transform expects matching (B, n) arrays, got {xr.shape} vs {xi.shape}"
        )
    b, n = xr.shape
    xr = np.ascontiguousarray(xr, dtype=np.float32)
    xi = np.ascontiguousarray(xi, dtype=np.float32)
    yr = np.empty_like(xr)
    yi = np.empty_like(xi)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.fftnative_transform(
        xr.ctypes.data_as(fp),
        xi.ctypes.data_as(fp),
        yr.ctypes.data_as(fp),
        yi.ctypes.data_as(fp),
        b,
        n,
        sign,
    )
    if rc != 0:
        # Error-code contract mirroring ffi/mlx_fft.c: nonzero = invalid input.
        raise ValueError(f"fftnative_transform failed with code {rc} (n={n}, batch={b})")
    return yr, yi


def forward(x):
    x = np.asarray(x, dtype=np.float32)
    return _run(x, np.zeros_like(x), -1)


def inverse(xr, xi):
    xr = np.asarray(xr, dtype=np.float32)
    xi = np.asarray(xi, dtype=np.float32)
    yr, yi = _run(xr, xi, +1)
    scale = np.float32(1.0 / xr.shape[-1])
    return yr * scale, yi * scale
