"""Training through the transform: learn FIR taps with jax.grad on the FFT.

Fits a 64-tap filter to a target band-pass frequency response by gradient
descent on a spectral loss — the loss, its gradient, and the update all run
through this library's measured transform paths (`rfft_device`), compiled
into ONE jitted step.  This is the pattern of any spectral-loss training
setup (vocoders, denoisers, physics surrogates): the FFT sits inside
`jax.grad`, so it must be differentiable and transposable — including the
staged large-N sizes (see ``tests/test_autodiff.py``).

Run: python examples/training.py
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

import gpu_fft_tpu as gf

N_TAPS = 64
N_FFT = 1024
H = N_FFT // 2 + 1


def main() -> None:
    # Target: a 0.2..0.3 (normalized) band-pass magnitude response.
    freqs = np.arange(H) / N_FFT
    target = ((freqs >= 0.2) & (freqs <= 0.3)).astype(np.float32)
    target_dev = jnp.asarray(target)

    def response(taps):
        # zero-pad the taps to the analysis length; one-sided magnitude
        padded = jnp.zeros((N_FFT,), jnp.float32).at[:N_TAPS].set(taps)
        hr, hi = gf.rfft_device(padded)
        return jnp.sqrt(hr**2 + hi**2 + 1e-12)

    def loss(taps):
        return jnp.mean((response(taps) - target_dev) ** 2)

    @jax.jit
    def step(taps, lr):
        g = jax.grad(loss)(taps)
        return taps - lr * g

    taps = jnp.zeros((N_TAPS,), jnp.float32).at[0].set(1.0)  # identity filter
    l0 = float(loss(taps))
    for i in range(500):
        taps = step(taps, jnp.float32(0.5))
    jax.block_until_ready(taps)
    l1 = float(loss(taps))
    print(f"spectral MSE: {l0:.5f} -> {l1:.5f} after 500 gradient steps")

    # Compare with the classical windowed design as a sanity reference.
    ref = gf.firwin(N_TAPS + 1, [0.2, 0.3], window="hamming", pass_zero=False, fs=1.0)
    ref_resp = np.abs(np.fft.rfft(ref, N_FFT))
    ref_mse = float(np.mean((ref_resp - target) ** 2))
    print(f"firwin(65) reference MSE: {ref_mse:.5f} (different tap budget, for scale)")

    # Apply the learned filter with the library's streaming path.
    rng = np.random.default_rng(0)
    x = rng.standard_normal(8192).astype(np.float32)
    y = gf.fftfilt(x, np.asarray(taps))
    f, pxx = gf.welch(y, fs=1.0, nperseg=256)
    band = (f >= 0.2) & (f <= 0.3)
    stop = (f < 0.15) | (f > 0.35)
    ratio = float(pxx[band].mean() / pxx[stop].mean())
    print(f"filtered noise: pass-band/stop-band power ratio {ratio:.1f}x")

    ok = l1 < 0.2 * l0 and ratio > 3.0
    print("OK" if ok else "FAIL")


if __name__ == "__main__":
    main()
