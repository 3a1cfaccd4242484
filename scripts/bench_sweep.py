"""Full benchmark sweep -> raw JSON.

The exhaustive analog of the reference's Criterion suite
(``benches/fft_bench.rs``: scalar/batch/radix sweeps; ``compare_bench.rs``:
backend comparison).  ``bench.py`` at the repo root is the quick headline
harness; this script runs the full matrix and writes
``bench-results/raw_<timestamp>.json``.

Every entry carries dispersion (median + IQR + min over >=5 paired reps, the
Criterion-statistics analog) and roofline columns (share of the device's
roofline and which bound sets it; utils/roofline.py).

Usage: python scripts/bench_sweep.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SIZES = [256, 1024, 4096, 16384, 65536, 262144]
BATCHES = [(16, 65536), (64, 4096), (16, 16384), (4, 262144)]


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true", help="fewer configs")
    parser.add_argument("--out", default=None)
    # Criterion-style baselines (reference scripts/bench.sh:8-9,32):
    parser.add_argument("--save-baseline", default=None, metavar="NAME",
                        help="also store results as bench-results/baselines/NAME.json")
    parser.add_argument("--baseline", default=None, metavar="NAME",
                        help="compare against a stored baseline and print deltas")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from gpu_fft_tpu.config import enable_compilation_cache

    enable_compilation_cache()  # cache hits only affect compile time, not timings

    from gpu_fft_tpu.utils import roofline
    from gpu_fft_tpu.utils.profiling import (
        chained_step_stats,
        conv2d_step,
        dct_roundtrip_step,
        firstream_step,
        fft_forward_step,
        fft_inverse_step,
        fft_roundtrip_step,
        fft_sequential_step,
        hilbert_step,
        ifft_sequential_step,
        oaconvolve_step,
        lfilter_step,
        resample_step,
        roundtrip_sequential_step,
        stft_roundtrip_step,
        welch_step,
        xla_fft_forward_step,
        xla_fft_inverse_step,
        xla_fft_roundtrip_step,
    )

    rng = np.random.default_rng(7)
    sizes = SIZES[:4] if args.quick else SIZES
    batches = BATCHES[:2] if args.quick else BATCHES
    chip = roofline.detect_chip()

    def dev(shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32))

    def fwd(n, backend):
        return xla_fft_forward_step(n) if backend == "xla" else fft_forward_step(n)

    def inv(n, backend):
        return xla_fft_inverse_step(n) if backend == "xla" else fft_inverse_step(n)

    def roundtrip(n, backend):
        return xla_fft_roundtrip_step(n) if backend == "xla" else fft_roundtrip_step(n)

    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True
        ).stdout.strip()
    except OSError:
        commit = "unknown"

    results = {
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "commit": commit,
        "device": {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        },
        "chip": chip.name,
        "method": "chained fori_loop, paired diffs, adaptive span, median+IQR over reps",
        "entries": [],
    }

    def run(name, kind, backend, b, n, step, shape=None):
        # ``shape`` overrides the step-input shape when it differs from the
        # roofline (b, n) — e.g. stft/welch consume a (1, L) signal but their
        # transform work is (num_frames, frame_size).
        try:
            x0 = dev(shape or (b, n))
            st = chained_step_stats(step, x0, k1=50, k2=1050, reps=5, retries=1)
            melem = b * n / st.median_s / 1e6
            entry = {
                "name": name,
                "kind": kind,
                "backend": backend,
                "batch": b,
                "n": n,
                "per_call_us": st.median_s * 1e6,
                "iqr_us": st.iqr_s * 1e6,
                "min_us": st.min_s * 1e6,
                "reps": st.reps,
                "suspect": st.suspect,
                "melem_per_s": melem,
            }
            entry["n_kernels"] = roofline.compiled_stats(step, x0)["n_kernels"]
            entry.update(roofline.roofline_row(b, n, kind, st.median_s, chip=chip))
            results["entries"].append(entry)
            print(
                f"{name:40s} {st.median_s * 1e6:9.2f} us ±{st.iqr_s * 1e6:6.2f}  "
                f"{melem:9.0f} Melem/s  {entry['pct_sol']:3.0f}% SoL"
                + (" SUSPECT" if st.suspect else ""),
                flush=True,
            )
        except Exception as e:
            print(f"{name:40s} ERROR {str(e)[:80]}", flush=True)

    for n in sizes:
        for backend in ("pallas", "xla"):
            run(f"fft/{backend}/n{n}", "fft", backend, 1, n, fwd(n, backend))
    for n in ([4096, 65536] if not args.quick else [4096]):
        for backend in ("pallas", "xla"):
            run(f"ifft/{backend}/n{n}", "ifft", backend, 1, n, inv(n, backend))
    if not args.quick:
        # Real-output inverse rows (the Hermitian-fold dispatch).
        from gpu_fft_tpu.utils.profiling import irfft_step

        for n in (65536, 1 << 20):
            run(f"irfft/pallas/n{n}", "irfft", "pallas", 1, n, irfft_step(n))
    for b, n in batches:
        for backend in ("pallas", "xla"):
            run(f"fft_batch/{backend}/b{b}_n{n}", "fft_batch", backend, b, n, fwd(n, backend))

    # Native CPU backend rows (the reference's 3-way backend comparison,
    # compare_bench.rs / README.md:134-150 — wgpu vs cuda vs mlx analog).
    from gpu_fft_tpu.backends import native as native_backend

    if native_backend.is_available() and not args.quick:
        for n in (4096, 65536):
            xh = rng.standard_normal((1, n)).astype(np.float32)
            try:
                native_backend.forward(xh)  # warm
                t0 = time.perf_counter()
                iters = 50
                for _ in range(iters):
                    native_backend.forward(xh)
                sec = (time.perf_counter() - t0) / iters
                results["entries"].append(
                    {
                        "name": f"fft/native/n{n}",
                        "kind": "fft",
                        "backend": "native",
                        "batch": 1,
                        "n": n,
                        "per_call_us": sec * 1e6,
                        "melem_per_s": n / sec / 1e6,
                    }
                )
                print(f"{'fft/native/n' + str(n):40s} {sec * 1e6:9.2f} us  {n / sec / 1e6:9.0f} Melem/s", flush=True)
            except Exception as e:
                print(f"fft/native/n{n} ERROR {str(e)[:60]}", flush=True)

    if not args.quick:
        # Batch-size sweep at fixed N (reference README.md:225-244 group).
        for b in (1, 4, 16, 64):
            run(f"fft_batchsize/pallas/b{b}_n4096", "fft_batchsize", "pallas", b, 4096, fwd(4096, "pallas"))
        # Roundtrip groups (reference README.md:283-298).
        for n in (4096, 65536):
            run(f"roundtrip/pallas/n{n}", "roundtrip", "pallas", 1, n, roundtrip(n, "pallas"))
        run("roundtrip/xla/n65536", "roundtrip", "xla", 1, 65536, roundtrip(65536, "xla"))
        # Batched inverse/roundtrip groups (reference fft_bench.rs:582-608).
        run("ifft_batch/pallas/b64_n4096", "ifft_batch", "pallas", 64, 4096, inv(4096, "pallas"))
        run("roundtrip_batch/pallas/b64_n4096", "roundtrip_batch", "pallas", 64, 4096,
            roundtrip(4096, "pallas"))
        # Extensions beyond reference parity (2-D and exact non-pow2).
        def fft2_step(h, w):
            from gpu_fft_tpu.ops.fft2d import fft2_device

            s = np.float32(1.0 / np.sqrt(h * w))

            def step(x):
                yr, _ = fft2_device(x)
                return yr * s

            return step

        def exact_step(n):
            from gpu_fft_tpu.ops.exact import fft_exact_device

            s = np.float32(1.0 / np.sqrt(n))

            def step(x):
                yr, _ = fft_exact_device(x)
                return yr * s

            return step

        run("fft2/pallas/256x512", "fft2", "pallas", 256, 512, fft2_step(256, 512))
        run("fft_exact/pallas/n48000", "fft_exact", "pallas", 1, 48000, exact_step(48000))
        # MEASURED sequential groups: B strictly ordered one-signal transforms
        # via lax.scan (reference README.md:250-290 batch-vs-sequential).
        run("fft_sequential/pallas/b64_n4096", "fft_sequential", "pallas", 64, 4096,
            fft_sequential_step(4096))
        run("ifft_sequential/pallas/b64_n4096", "ifft_sequential", "pallas", 64, 4096,
            ifft_sequential_step(4096))
        run("roundtrip_sequential/pallas/b64_n4096", "roundtrip_sequential", "pallas", 64, 4096,
            roundtrip_sequential_step(4096))
        # Analysis ops (round-2 extensions): end-to-end pipelines through the
        # library transforms.  (b, n) below is the transform work each step
        # performs; stft/welch consume a (1, L) signal (shape override).
        sig_l = 16384
        frames = (sig_l - 256) // 64 + 1
        run("stft_roundtrip/pallas/f256_h64_L16384", "stft_roundtrip", "pallas",
            frames, 256, stft_roundtrip_step(256, 64), shape=(1, sig_l))
        wl = 65536
        wseg = (wl - 256) // 128 + 1
        run("welch/pallas/seg256_L65536", "welch", "pallas",
            wseg, 256, welch_step(256), shape=(1, wl))
        run("dct_roundtrip/pallas/b16_n4096", "dct_roundtrip", "pallas", 16, 4096,
            dct_roundtrip_step())
        run("hilbert/pallas/b16_n16384", "hilbert", "pallas", 16, 16384, hilbert_step())
        run("resample/pallas/n65536_mid32768", "resample", "pallas", 1, 65536,
            resample_step(65536, 32768))
        # FIR filtering family (round-2 filter wave): streaming overlap-add
        # convolution and 2-D image convolution.  Roofline (b, n) is the
        # block/padded transform the step actually runs.
        from gpu_fft_tpu.ops.filter import _best_block_fft_size, firwin

        sig_n, taps_n = 262144, 257
        blk = _best_block_fft_size(taps_n)
        nblk = -(-sig_n // (blk - taps_n + 1))
        run(f"oaconvolve/pallas/L{sig_n}_t{taps_n}", "oaconvolve", "pallas",
            nblk, blk, oaconvolve_step(sig_n, firwin(taps_n, 0.25)),
            shape=(1, sig_n))
        kern2d = rng.standard_normal((17, 17)).astype(np.float32)
        run("conv2d/pallas/496x496_k17", "conv2d", "pallas", 512, 512,
            conv2d_step(kern2d), shape=(1, 496, 496))
        # Streaming FIR serving: FIRStream steady-state, 4 live channels.
        # Roofline (b, n) = (batch, padded transform length) per step.
        run("firstream/pallas/c4096_t129_b4", "oaconvolve", "pallas",
            4, 8192, firstream_step(4096, 129, batch=4), shape=(4, 4096 + 128))
        # IIR block-state engine (round-3): order-4 Butterworth over 65,536
        # samples.  SoL charge = the zero-state convolutions (64 blocks of
        # 1024 conv'd at 2048), the dominant term; state matmuls are O(n*k)
        # and uncharged so the bound stays a bound (ops/iir.py).
        import scipy.signal as _ss

        _iirb, _iira = _ss.butter(4, 0.15)
        run("lfilter/pallas/n65536_o4", "oaconvolve", "pallas",
            64, 2048, lfilter_step(_iirb, _iira), shape=(1, 65536))

    out = args.out or f"bench-results/raw_{time.strftime('%Y%m%d_%H%M%S')}.json"
    pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out}")

    base_dir = pathlib.Path("bench-results/baselines")
    if args.save_baseline:
        base_dir.mkdir(parents=True, exist_ok=True)
        (base_dir / f"{args.save_baseline}.json").write_text(json.dumps(results, indent=2))
        print(f"saved baseline '{args.save_baseline}'")
    if args.baseline:
        path = base_dir / f"{args.baseline}.json"
        if not path.is_file():
            print(f"no baseline named '{args.baseline}'")
        else:
            old = {e["name"]: e for e in json.loads(path.read_text())["entries"]}
            print(f"vs baseline '{args.baseline}':")
            for e in results["entries"]:
                o = old.get(e["name"])
                if o:
                    delta = (e["per_call_us"] - o["per_call_us"]) / o["per_call_us"] * 100
                    marker = "+" if delta >= 0 else ""
                    print(f"  {e['name']:40s} {marker}{delta:6.1f}% "
                          f"({o['per_call_us']:.2f} -> {e['per_call_us']:.2f} us)")


if __name__ == "__main__":
    main()
