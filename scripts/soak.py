"""Hardware soak: random configs through the device API vs the on-device oracle.

The test suite pins known boundaries; this harness hammers RANDOM (B, n)
configs on real hardware — including memory-heavy batches — comparing each
against `jnp.fft` computed on device (no host oracle transfers), to catch
memory/layout regressions at shapes nobody hand-picked.  Exits non-zero on
any failure.

Usage: python scripts/soak.py [--iters N] [--seed S] [--max-bytes B]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def analysis_soak(rng, iters: int) -> tuple[int, int]:
    """Random-config identity checks over the analysis ops (round-2 wave).

    Each op has a mathematical identity that needs no host oracle:
    istft(stft(x)) == x on covered samples; idct(dct(x)) == x (both kinds,
    both norms); Re(analytic(x)) == x; resample(resample(x, 2n), n) == x
    (up-then-down through band-limited interpolation is exact).
    """
    import jax.numpy as jnp

    import gpu_fft_tpu as gf

    failures = 0
    for _ in range(iters):
        op = rng.choice(
            ["stft", "dct", "dst", "hilbert", "resample", "oaconvolve", "conv2d",
             "upfirdn", "fht", "compat"]
        )
        try:
            if op == "stft":
                frame = 1 << int(rng.integers(4, 10))
                hop = max(1, frame >> int(rng.integers(1, 3)))
                ln = frame * int(rng.integers(2, 30)) + int(rng.integers(0, frame))
                window = rng.choice(["hann", "hamming", "blackman", "rect"])
                x = rng.uniform(-1, 1, ln).astype(np.float32)
                sr, si = gf.stft(x, frame, hop=hop, window=window)
                y = gf.istft(sr, si, hop=hop, window=window, length=ln)
                num = (ln - frame) // hop + 1
                cov = (num - 1) * hop + frame
                w = gf.window_table(window, frame).astype(np.float64)
                wsq = np.zeros(cov)
                for m in range(num):
                    wsq[m * hop : m * hop + frame] += w * w
                ok = wsq > 1e-6
                err = float(np.abs(y[:cov][ok] - x[:cov][ok]).max())
                good = err < 5e-3
                desc = f"stft f={frame} h={hop} L={ln} w={window}"
            elif op in ("dct", "dst"):
                n = int(rng.integers(2, 20000))
                b = int(rng.choice([1, 3, 8]))
                type_ = int(rng.choice([1, 2, 3, 4]))
                norm = rng.choice([None, "ortho"])
                fn = gf.dct_device if op == "dct" else gf.dst_device
                ifn = gf.idct_device if op == "dct" else gf.idst_device
                x = jnp.asarray(rng.uniform(-1, 1, (b, n)).astype(np.float32))
                y = np.asarray(ifn(fn(x, type=type_, norm=norm), type=type_, norm=norm))
                err = float(np.abs(y - np.asarray(x)).max())
                good = err < 5e-3
                desc = f"{op}{type_} b={b} n={n} norm={norm}"
            elif op == "hilbert":
                n = int(rng.integers(2, 50000))
                b = int(rng.choice([1, 4]))
                x = jnp.asarray(rng.uniform(-1, 1, (b, n)).astype(np.float32))
                ar, _ = gf.hilbert_device(x)
                err = float(np.abs(np.asarray(ar) - np.asarray(x)).max())
                good = err < 5e-3
                desc = f"hilbert b={b} n={n}"
            elif op == "resample":
                n = int(rng.integers(2, 20000))
                x = jnp.asarray(rng.uniform(-1, 1, (1, n)).astype(np.float32))
                up = gf.resample_device(x, 2 * n)
                y = np.asarray(gf.resample_device(up, n))
                err = float(np.abs(y - np.asarray(x)).max())
                good = err < 5e-3
                desc = f"resample n={n}<->{2 * n}"
            elif op == "oaconvolve":
                # Cross-check the block path against the independent
                # single-transform path, both on device.
                n = int(rng.integers(100, 150000))
                lh = int(rng.integers(2, 513))
                b = int(rng.choice([1, 4]))
                x = jnp.asarray(rng.uniform(-1, 1, (b, n)).astype(np.float32))
                h = jnp.asarray(rng.uniform(-1, 1, lh).astype(np.float32))
                ya = np.asarray(gf.oaconvolve_device(x, h))
                yb = np.asarray(gf.fft_convolve_device(x, h))
                scale = max(1.0, float(np.abs(yb).max()))
                err = float(np.abs(ya - yb).max()) / scale
                good = err < 5e-3
                desc = f"oaconvolve b={b} n={n} lh={lh}"
            elif op == "upfirdn":
                import scipy.signal as _ss

                n = int(rng.integers(16, 30000))
                lh = int(rng.integers(1, 129))
                up = int(rng.integers(1, 8))
                down = int(rng.integers(1, 8))
                x = rng.uniform(-1, 1, n).astype(np.float32)
                hh = rng.uniform(-1, 1, lh).astype(np.float32)
                ya = np.asarray(gf.upfirdn(hh, x, up, down))
                yb = _ss.upfirdn(hh.astype(np.float64), x.astype(np.float64), up, down)
                scale = max(1.0, float(np.abs(yb).max()))
                err = float(np.abs(ya - yb).max()) / scale
                good = err < 5e-3 and ya.shape == yb.shape
                desc = f"upfirdn n={n} lh={lh} {up}/{down}"
            elif op == "fht":
                # FFTLog roundtrip identity: ifht(fht(a)) == a at any length.
                n = int(rng.integers(4, 8192))
                dln = float(rng.uniform(0.005, 0.2))
                mu = float(rng.uniform(-0.9, 3.0))
                bias = float(rng.choice([0.0, rng.uniform(-0.8, 0.8)]))
                off = gf.fhtoffset(dln, mu, bias=bias)
                r = np.exp((np.arange(n) - (n - 1) / 2) * dln)
                a = (r**1.2 * np.exp(-r * r / 2)).astype(np.float32)
                back = np.asarray(
                    gf.ifht_device(
                        gf.fht_device(a, dln, mu, offset=off, bias=bias),
                        dln, mu, offset=off, bias=bias,
                    )
                )
                scale = max(1e-3, float(np.abs(a).max()))
                err = float(np.abs(back - a).max()) / scale
                good = err < 5e-3
                desc = f"fht n={n} dln={dln:.3f} mu={mu:.2f} q={bias:.2f}"
            elif op == "compat":
                # scipy-namespace roundtrip on device: ifft(fft(x, n)) == fit(x, n)
                # with random length/axis/norm; errors reduced ON DEVICE.
                from gpu_fft_tpu import compat as cfft

                n = int(rng.integers(2, 20000))
                b = int(rng.choice([1, 4]))
                norm = rng.choice([None, "ortho", "forward"])
                axis = int(rng.choice([0, 1]))
                shape = (b, n) if axis == 1 else (n, b)
                x = jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32))
                y = cfft.ifft(cfft.fft(x, axis=axis, norm=norm), axis=axis, norm=norm)
                err = float(jnp.abs(jnp.real(y) - x).max())
                err = max(err, float(jnp.abs(jnp.imag(y)).max()))
                good = err < 5e-3
                desc = f"compat fft/ifft b={b} n={n} axis={axis} norm={norm}"
            else:  # conv2d: separable-kernel identity vs two 1-D passes
                hgt = int(rng.integers(8, 200))
                wid = int(rng.integers(8, 200))
                kh = int(rng.integers(2, 17))
                kw = int(rng.integers(2, 17))
                x = jnp.asarray(rng.uniform(-1, 1, (hgt, wid)).astype(np.float32))
                u = rng.uniform(-1, 1, kh).astype(np.float32)
                v = rng.uniform(-1, 1, kw).astype(np.float32)
                y2 = np.asarray(gf.fft_convolve2d_device(x, jnp.asarray(np.outer(u, v))))
                rows = gf.fft_convolve_device(x, jnp.asarray(v))  # (hgt, wid+kw-1)
                cols = np.asarray(gf.fft_convolve_device(rows.T, jnp.asarray(u))).T
                scale = max(1.0, float(np.abs(cols).max()))
                err = float(np.abs(y2 - cols).max()) / scale
                good = err < 5e-3
                desc = f"conv2d {hgt}x{wid} k{kh}x{kw}"
        except Exception as e:
            print(f"{op}: EXCEPTION {str(e)[:120]}", flush=True)
            failures += 1
            continue
        print(f"{desc}: err {err:.1e} {'ok' if good else 'FAIL'}", flush=True)
        failures += 0 if good else 1
    return iters, failures


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-bytes", type=int, default=512 * 1024 * 1024)
    ap.add_argument("--analysis-iters", type=int, default=None,
                    help="analysis-op identity checks (default: iters // 2)")
    args = ap.parse_args()

    import jax.numpy as jnp

    import gpu_fft_tpu as gf
    from gpu_fft_tpu.config import enable_compilation_cache

    enable_compilation_cache()
    rng = np.random.default_rng(args.seed)
    failures = 0
    ran = 0
    while ran < args.iters:
        b = int(rng.choice([1, 2, 3, 8, 24, 96, 256, 1024]))
        n = 1 << int(rng.integers(1, 21))
        # Peak footprint is ~8x the input: complex64 oracle (2x), two
        # split-complex result pairs (4x), plus staged intermediates.
        if b * n * 4 * 8 > args.max_bytes:
            continue
        ran += 1
        xs = jnp.asarray(rng.uniform(-1, 1, (b, n)).astype(np.float32))
        try:
            yr, yi = gf.fft_device(xs)
            rr, ri = gf.ifft_device(yr, yi)
            spec = jnp.fft.fft(xs.astype(jnp.complex64))
            denom = jnp.max(jnp.abs(spec)) + 1e-9
            # Check BOTH components: real input has Re(conj X) == Re(X), so a
            # conjugation regression would slip past a real-only gate.
            fwd = float(
                jnp.maximum(
                    jnp.max(jnp.abs(yr - jnp.real(spec))),
                    jnp.max(jnp.abs(yi - jnp.imag(spec))),
                )
                / denom
            )
            rt = float(jnp.max(jnp.abs(rr - xs)))
            bound = 5.0 * np.log2(max(n, 2)) * float(np.finfo(np.float32).eps)
            good = fwd < 1e-4 and rt <= max(bound, 1e-5)
        except Exception as e:  # any crash is a failure worth a red exit
            print(f"b={b:5d} n={n:8d}: EXCEPTION {str(e)[:120]}", flush=True)
            failures += 1
            continue
        print(f"b={b:5d} n={n:8d}: fwd {fwd:.1e} roundtrip {rt:.1e} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        failures += 0 if good else 1

    a_iters = args.iters // 2 if args.analysis_iters is None else args.analysis_iters
    a_ran, a_fail = analysis_soak(rng, a_iters)
    ran += a_ran
    failures += a_fail
    print(f"soak: {ran - failures}/{ran} ok")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
