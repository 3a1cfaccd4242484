"""Command-line interface: ``python -m gpu_fft_tpu <command>``.

The reference ships example binaries (``examples/simple.rs``,
``examples/backends.rs``); this CLI exposes the same workloads plus a quick
benchmark, so the library is driveable without writing code.

Commands:
  demo       the end-to-end sine -> FFT -> PSD -> peak -> IFFT workload
  backends   enumerate available backends and roundtrip through each
  bench      quick on-device benchmark of one (batch, n) configuration
  plan       explain how a (batch, n) transform will dispatch (no device)
  export     AOT-compile one transform to a serialized serving artifact
  serve-check  load an artifact, run it, and verify against the live path
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def cmd_demo(_args) -> int:
    import gpu_fft_tpu as gf
    from gpu_fft_tpu.utils import (
        calculate_one_sided_frequencies,
        find_dominant_frequencies,
        generate_sine_wave,
    )

    wave = generate_sine_wave(15.0, 200.0, 5.0)
    print(f"Generated {len(wave)} samples of a 15 Hz sine wave")
    re, im = gf.fft(wave)
    p = gf.psd(re, im)
    n = len(re)
    freqs = calculate_one_sided_frequencies(n, 200.0)
    for f, power in find_dominant_frequencies(p[: n // 2 + 1], freqs, 100.0):
        print(f"Dominant frequency: {f:.2f} Hz (power {power:.2f})")
    out = gf.ifft(re, im)
    err = float(np.abs(out[: len(wave)] - wave).max())
    limit = 5.0 * np.log2(n) * float(np.finfo(np.float32).eps)
    print(f"Roundtrip max error {err:.3e} vs limit {limit:.3e} "
          f"[{'OK' if err <= limit else 'FAIL'}]")
    return 0 if err <= limit else 1


def cmd_backends(_args) -> int:
    import gpu_fft_tpu as gf

    x = np.array([0.0, 1.0, 2.0, 3.0, 2.0, 1.0, 0.0, -1.0], dtype=np.float32)
    print("Available backends:", [b.name for b in gf.available_backends()])
    for backend in gf.available_backends():
        re, im = gf.fft_with(x, backend)
        out = gf.ifft_with(re, im, backend)
        err = float(np.abs(out[: len(x)] - x).max())
        print(f"{backend.name:8s} roundtrip max error: {err:.3e}")
    return 0


def cmd_bench(args) -> int:
    import jax.numpy as jnp

    from gpu_fft_tpu.kernels.large import transform_any
    from gpu_fft_tpu.utils.profiling import benchmark

    b, n = args.batch, args.n
    if n & (n - 1) or n < 2:
        print(f"n must be a power of two >= 2, got {n}", file=sys.stderr)
        return 2
    x = jnp.asarray(np.random.default_rng(0).standard_normal((b, n)).astype(np.float32))
    s = np.float32(1.0 / np.sqrt(n))
    r = benchmark(lambda xx: transform_any(xx, None, n, -1)[0] * s, x, elements=b * n)
    print(f"fft B={b} n={n}: {r.microseconds:.2f} us/transform, {r.melem_per_s:.0f} Melem/s")
    return 0


def cmd_plan(args) -> int:
    from gpu_fft_tpu.plan import describe_plan

    try:
        info = describe_plan(args.n, batch=args.batch)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    width = max(len(k) for k in info)
    for k, v in info.items():
        print(f"{k:{width}s}  {v}")
    return 0


def cmd_export(args) -> int:
    from gpu_fft_tpu.utils.serving import save_transform

    platforms = tuple(args.platforms.split(",")) if args.platforms else None
    size = save_transform(args.output, args.kind, args.batch, args.n, platforms)
    print(f"exported {args.kind} (batch={args.batch}, n={args.n}) "
          f"-> {args.output} ({size} bytes)")
    return 0


def cmd_serve_check(args) -> int:
    from gpu_fft_tpu.utils.serving import exported_call, load_transform

    exported = load_transform(args.artifact)
    specs = exported.in_avals
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal(s.shape).astype(np.float32) for s in specs]
    out = exported_call(exported, *inputs)
    flat = out if isinstance(out, (tuple, list)) else (out,)
    print(f"artifact: {len(specs)} input(s) "
          f"{[tuple(s.shape) for s in specs]} -> {len(flat)} output(s), "
          f"platforms={exported.platforms}")
    print("first output head:", np.asarray(flat[0]).ravel()[:4])
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gpu_fft_tpu", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("demo", help="end-to-end signal-processing demo")
    sub.add_parser("backends", help="enumerate + roundtrip every backend")
    pb = sub.add_parser("bench", help="quick on-device benchmark")
    pb.add_argument("--batch", type=int, default=1)
    pb.add_argument("-n", type=int, default=65536)
    pp = sub.add_parser("plan", help="dispatch introspection (pure arithmetic)")
    pp.add_argument("--batch", type=int, default=1)
    pp.add_argument("-n", type=int, default=65536)
    pe = sub.add_parser("export", help="AOT-export one transform to an artifact")
    pe.add_argument("--kind", default="fft",
                    choices=("fft", "ifft", "rfft", "irfft", "roundtrip", "psd"))
    pe.add_argument("--batch", type=int, default=1)
    pe.add_argument("-n", type=int, default=65536)
    pe.add_argument("-o", "--output", required=True)
    pe.add_argument("--platforms", default=None,
                    help="comma-separated lowering platforms, e.g. cuda,cpu")
    ps = sub.add_parser("serve-check", help="load + run an exported artifact")
    ps.add_argument("artifact")
    args = parser.parse_args(argv)
    if args.command != "plan":
        # Persistent compilation cache: repeat CLI invocations skip the
        # first compile of each transform.
        # (``plan`` is pure arithmetic — it never touches a device.)
        from gpu_fft_tpu.config import enable_compilation_cache

        enable_compilation_cache()
    return {
        "demo": cmd_demo,
        "backends": cmd_backends,
        "bench": cmd_bench,
        "plan": cmd_plan,
        "export": cmd_export,
        "serve-check": cmd_serve_check,
    }[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
