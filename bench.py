"""Benchmark harness: one JSON headline line on stdout, full matrix to
BENCH_DETAILS.json.

Configs mirror the reference benchmark suite (``benches/fft_bench.rs``):
scalar fwd/inv sweep over N, batched transforms, MEASURED batch-vs-sequential
speedups (fft/ifft/roundtrip, the ``README.md:250-290`` groups), roundtrip,
backend comparison (the library's engine vs the XLA vendor FFT, which is
cuFFT on the GPU — the analog of ``benches/compare_bench.rs``'s WGPU-vs-MLX
groups), and the accuracy gate (roundtrip error vs 5*log2(N)*eps,
``tests/roundtrip.rs:63``).  Every output names the device's platform, kind
and count; a device without a row in the device table is an error.

Timing methodology — chained on-device iteration with credibility guards:
    Each config runs x = step(x) inside ``lax.fori_loop`` for two trip counts
    and differences the wall times (see utils/profiling.py): steady-state
    per-transform device time with the readback floor cancelled.  Adaptive
    chain spans (the signal must exceed ~80 ms of device time), >=5 paired
    reps with median + IQR dispersion per config, positive clamping with
    ``suspect`` flags, and cross-config sanity invariants (roundtrip >=
    max(fwd, inv), per-transform time monotone in N) that trigger one
    re-measure and are recorded if still violated.  Throughput =
    elements/second, matching Criterion's ``Throughput::Elements``
    (``fft_bench.rs:76``).

Roofline accounting: every config carries the algorithm's FLOPs and bytes,
the least time the device could take at its published peaks, the share of
it the measurement reached, and which bound (compute or HBM) sets it — see
utils/roofline.py.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

# Reference headline: scalar fft N=65,536 at 69.73 Melem/s on M4 Mini/wgpu
# (reference README.md:171, BASELINE.md).
BASELINE_FFT_65536_MELEM_S = 69.73

RNG = np.random.default_rng(42)

def main() -> None:
    import jax
    import jax.numpy as jnp

    import gpu_fft_tpu as gf
    from gpu_fft_tpu.utils import roofline
    from gpu_fft_tpu.utils.profiling import (
        chained_step_stats,
        fft_forward_step,
        fft_inverse_step,
        fft_roundtrip_step,
        fft_sequential_step,
        ifft_sequential_step,
        roundtrip_sequential_step,
        xla_fft_forward_step,
    )

    # Persistent compile cache: repeat bench runs skip the per-config
    # first-compiles (the cache stores executables; measured times are
    # unaffected — chained timing never includes compilation).
    from gpu_fft_tpu.config import PRECISION, enable_compilation_cache

    enable_compilation_cache()

    start = time.time()
    d0 = jax.devices()[0]
    device = {"platform": d0.platform, "kind": d0.device_kind, "count": len(jax.devices())}
    chip = roofline.detect_chip()  # raises on a device without a table row
    details: dict = {
        "device": device,
        "precision": PRECISION,
        "chip": {
            "name": chip.name,
            "fp32_tflops": chip.fp32_tflops,
            "tf32_tflops": chip.tf32_tflops,
            "hbm_gbps": chip.hbm_gbps,
            "source": chip.source,
        },
        "method": (
            "chained fori_loop, paired (T(k2)-T(k1))/(k2-k1) diffs, adaptive span, "
            "median+IQR over reps, scalar-readback sync"
        ),
        "configs": {},
    }

    def dev(shape):
        return jnp.asarray(RNG.standard_normal(shape).astype(np.float32))

    def record(name, step, x0, *, b, n, kind):
        try:
            s = chained_step_stats(step, x0, k1=50, k2=1050, reps=5, retries=1)
            elems = b * n
            melem = elems / s.median_s / 1e6
            row = {
                "per_call_s": s.median_s,
                "iqr_s": s.iqr_s,
                "min_s": s.min_s,
                "max_s": s.max_s,
                "reps": s.reps,
                "span": s.span,
                "suspect": s.suspect,
                "melem_per_s": melem,
                "batch": b,
                "n": n,
                "kind": kind,
            }
            # Kernel count of the compiled step; the compiled-HLO
            # fingerprint lets the regression gate separate code
            # regressions from environment drift.
            cs = roofline.compiled_stats(step, x0)
            row["n_kernels"] = cs["n_kernels"]
            row["hlo_fp"] = cs["fingerprint"]
            row.update(roofline.roofline_row(b, n, kind, s.median_s, chip=chip))
            details["configs"][name] = row
            print(
                f"[bench] {name}: {s.median_s * 1e6:.2f} us "
                f"(iqr {s.iqr_s * 1e6:.2f}), {melem:.0f} Melem/s, "
                f"{row['pct_sol']:.0f}% SoL ({row['bound']})"
                + (" SUSPECT" if s.suspect else ""),
                file=sys.stderr,
                flush=True,
            )
            return s.median_s
        except Exception as e:  # keep the harness robust on odd platforms
            details["configs"][name] = {"error": str(e)[:300], "kind": kind, "batch": b, "n": n}
            print(f"[bench] {name}: ERROR {str(e)[:120]}", file=sys.stderr, flush=True)
            return None

    steps: dict = {}  # keep step/x0 for possible re-measures

    def measure(name, step, x0, *, b, n, kind):
        steps[name] = (step, x0, b, n, kind)
        return record(name, step, x0, b=b, n=n, kind=kind)

    # ── Scalar forward sweep (fft_bench.rs SIZES + large-N extension) ───────
    for n in (1024, 4096, 16384, 65536, 1 << 20):
        measure(f"fft_n{n}", fft_forward_step(n), dev((1, n)), b=1, n=n, kind="fft")

    # ── Inverse + roundtrip at the headline size ────────────────────────────
    measure("ifft_n65536", fft_inverse_step(65536), dev((1, 65536)), b=1, n=65536, kind="ifft")
    # Real-output inverse rows: the Hermitian-fold dispatch.
    from gpu_fft_tpu.utils.profiling import irfft_step

    measure("irfft_n65536", irfft_step(65536), dev((1, 65536)), b=1, n=65536, kind="irfft")
    measure(
        "irfft_n1048576", irfft_step(1 << 20), dev((1, 1 << 20)), b=1, n=1 << 20, kind="irfft"
    )
    measure(
        "roundtrip_n65536",
        fft_roundtrip_step(65536),
        dev((1, 65536)),
        b=1,
        n=65536,
        kind="roundtrip",
    )

    # ── Gradient path: jitted reverse-mode through the transform (the
    # custom-JVP seam over the stage-A kernel; tests/test_autodiff.py).
    # The step IS a spectral-loss training step's derivative: grad of
    # sum|FFT(x)|^2, rescaled by Parseval's 1/(2n) so the chain is the
    # identity map and stays bounded.
    def grad_step(n):
        from gpu_fft_tpu.ops.transform import fft_device

        def power(v):
            yr, yi = fft_device(v)
            return jnp.sum(yr**2 + yi**2)

        g = jax.grad(power)
        s = np.float32(1.0 / (2.0 * n))

        def step(x):
            return g(x) * s

        return step

    measure("grad_fft_n65536", grad_step(65536), dev((1, 65536)), b=1, n=65536, kind="grad_fft")
    measure(
        "grad_fft_n1048576", grad_step(1 << 20), dev((1, 1 << 20)), b=1, n=1 << 20, kind="grad_fft"
    )

    # ── Batched groups (fft_bench.rs BATCH_SIZES x BATCH_N + ifft/roundtrip) ─
    measure(
        "fft_batch_b16_n65536", fft_forward_step(65536), dev((16, 65536)), b=16, n=65536, kind="fft_batch"
    )
    measure(
        "fft_batch_b64_n4096", fft_forward_step(4096), dev((64, 4096)), b=64, n=4096, kind="fft_batch"
    )
    measure(
        "ifft_batch_b64_n4096", fft_inverse_step(4096), dev((64, 4096)), b=64, n=4096, kind="ifft_batch"
    )
    measure(
        "roundtrip_batch_b64_n4096",
        fft_roundtrip_step(4096),
        dev((64, 4096)),
        b=64,
        n=4096,
        kind="roundtrip_batch",
    )

    # ── MEASURED batch-vs-sequential (reference README.md:250-290) ──────────
    # B strictly sequential one-signal transforms (lax.scan) vs one batched
    # pass over the same (64, 4096) data — directly comparable to the
    # reference's 13.5x / 13.8x / 14.6x.
    measure(
        "fft_sequential_b64_n4096",
        fft_sequential_step(4096),
        dev((64, 4096)),
        b=64,
        n=4096,
        kind="fft_sequential",
    )
    measure(
        "ifft_sequential_b64_n4096",
        ifft_sequential_step(4096),
        dev((64, 4096)),
        b=64,
        n=4096,
        kind="ifft_sequential",
    )
    measure(
        "roundtrip_sequential_b64_n4096",
        roundtrip_sequential_step(4096),
        dev((64, 4096)),
        b=64,
        n=4096,
        kind="roundtrip_sequential",
    )

    # ── Extensions beyond reference parity: 2-D and exact non-pow2 ──────────
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

    measure("fft2_256x512", fft2_step(256, 512), dev((256, 512)), b=256, n=512, kind="fft2")
    measure("fft_exact_n48000", exact_step(48000), dev((1, 48000)), b=1, n=48000, kind="fft_exact")

    # Analysis-op pipelines (gather-free framing/overlap-add).
    # (b, n) is the transform work — (num_frames, frame) — while the step
    # consumes a (1, L) signal.
    from gpu_fft_tpu.utils.profiling import stft_roundtrip_step, welch_step

    measure(
        "stft_roundtrip_f256_h64_L16384",
        stft_roundtrip_step(256, 64),
        dev((1, 16384)),
        b=(16384 - 256) // 64 + 1,
        n=256,
        kind="stft_roundtrip",
    )
    measure(
        "welch_seg256_L65536",
        welch_step(256),
        dev((1, 65536)),
        b=(65536 - 256) // 128 + 1,
        n=256,
        kind="welch",
    )

    # ── Backend comparison: XLA vendor FFT (compare_bench.rs analog) ────────
    measure("xla_fft_n65536", xla_fft_forward_step(65536), dev((1, 65536)), b=1, n=65536, kind="fft")
    measure(
        "xla_fft_batch_b16_n65536",
        xla_fft_forward_step(65536),
        dev((16, 65536)),
        b=16,
        n=65536,
        kind="fft_batch",
    )

    # ── Sanity invariants: no physically impossible rows ────────────────────
    c = details["configs"]

    def t(name):
        row = c.get(name) or {}
        return row.get("per_call_s")

    def remeasure(name):
        step, x0, b, n, kind = steps[name]
        print(f"[bench] invariant violated -> re-measuring {name}", file=sys.stderr, flush=True)
        record(name, step, x0, b=b, n=n, kind=kind)

    violations = []
    # roundtrip must cost at least the dearer of its two halves.
    for rt, fwd, inv in (("roundtrip_n65536", "fft_n65536", "ifft_n65536"),):
        if t(rt) and t(fwd) and t(inv) and t(rt) < max(t(fwd), t(inv)) * 0.95:
            remeasure(rt)
            if t(rt) and t(rt) < max(t(fwd), t(inv)) * 0.95:
                violations.append(f"{rt} < max({fwd}, {inv})")
                c[rt]["suspect"] = True
    # Per-transform time must not decrease as N grows (same batch).  The
    # threshold is loose (1.25x) because small genuine inversions exist
    # between splits of different shapes.
    sweep = [f"fft_n{n}" for n in (1024, 4096, 16384, 65536, 1 << 20)]

    def _nonmonotonic(a, bname):
        ta, tb = t(a), t(bname)
        if not (ta and tb) or ta <= tb * 1.25:
            return False
        # Dispatch-floor noise waiver: when the excess beyond the threshold
        # is inside the pair's combined IQR, the "inversion" is within the
        # measurement's own dispersion, not a physically impossible row.
        iqr = (c[a].get("iqr_s") or 0.0) + (c[bname].get("iqr_s") or 0.0)
        return ta - tb * 1.25 > iqr

    for a, bname in zip(sweep, sweep[1:]):
        if _nonmonotonic(a, bname):
            remeasure(a)
            if _nonmonotonic(a, bname):
                violations.append(f"{a} > {bname}")
                c[a]["suspect"] = True
    # The roofline is a lower bound by construction: a measurement beating
    # it means the cost model no longer mirrors the live dispatch.
    for name, row in c.items():
        if row.get("pct_sol", 0.0) > 105.0:
            violations.append(f"{name} pct_sol {row['pct_sol']:.0f} > 100 (+margin)")
            row["suspect"] = True
    details["invariant_violations"] = violations

    # Measured batch-vs-sequential speedups.
    speedups = {}
    for kind, seq, bat in (
        ("fft", "fft_sequential_b64_n4096", "fft_batch_b64_n4096"),
        ("ifft", "ifft_sequential_b64_n4096", "ifft_batch_b64_n4096"),
        ("roundtrip", "roundtrip_sequential_b64_n4096", "roundtrip_batch_b64_n4096"),
    ):
        if t(seq) and t(bat):
            speedups[kind] = t(seq) / t(bat)
    details["batch_vs_sequential_measured_b64_n4096"] = speedups

    # ── Regression gate against the previous run ────────────────────────────
    # The reference workflow diffs every bench run against a stored Criterion
    # baseline (scripts/bench.sh:8-9,32, README.md:352-355); the analog here
    # compares each config against the previous run's stored details on the
    # same device and flags any slowdown beyond the config's IQR (and a 3%
    # floor, so jitter on microsecond rows does not cry wolf).
    details["regression"] = regression_report(details)

    # ── Accuracy gate: roundtrip err <= 5*log2(N)*eps ───────────────────────
    # Protected per size like the timing configs: a failure here must not
    # discard the measured results.  The PALLAS backend is forced so env
    # overrides (e.g. GPU_FFT_TPU_BACKEND=native) cannot break the device API.
    eps32 = float(np.finfo(np.float32).eps)
    acc = {}
    for n in (1024, 4096, 65536, 1 << 20, 1 << 22):
        try:
            xs_h = RNG.uniform(-1.0, 1.0, n).astype(np.float32)
            r, i = gf.fft_device(jnp.asarray(xs_h[None]), backend=gf.Backend.PALLAS)
            rr, _ = gf.ifft_device(r, i, backend=gf.Backend.PALLAS)
            err = float(np.abs(np.asarray(rr[0]) - xs_h).max())
            bound = float(5.0 * np.log2(n) * eps32)
            acc[f"n{n}"] = {"max_err": err, "bound": bound, "pass": bool(err <= bound)}
        except Exception as e:
            acc[f"n{n}"] = {"error": str(e)[:200], "pass": False}
    details["accuracy"] = acc
    details["accuracy_all_pass"] = all(v["pass"] for v in acc.values())

    details["wall_s"] = time.time() - start

    headline = (details["configs"].get("fft_n65536") or {}).get("melem_per_s", 0.0) or 0.0
    details["headline"] = {
        "metric": "fft_n65536_device_melem_per_s",
        "value": headline,
        "baseline": BASELINE_FFT_65536_MELEM_S,
    }
    with open("BENCH_DETAILS.json", "w") as f:
        json.dump(details, f, indent=2)

    # ── Baseline lifecycle ──────────────────────────────────────────────────
    # The reference SAVES a Criterion baseline every run and compares the
    # next run against it (scripts/bench.sh:32-37).  Every completed run
    # archives the old baseline and stores its own details — with HLO
    # fingerprints — as the next run's baseline.
    # Set GPU_FFT_TPU_BENCH_KEEP_BASELINE=1 to compare-only (ad-hoc runs).
    import os

    if not os.environ.get("GPU_FFT_TPU_BENCH_KEEP_BASELINE"):
        save_baseline(details)

    print(
        json.dumps(
            {
                "metric": "fft_n65536_melem_per_s",
                "value": round(headline, 2),
                "unit": "Melem/s",
                "vs_baseline": round(headline / BASELINE_FFT_65536_MELEM_S, 2),
                "device": device,
            }
        )
    )


def save_baseline(
    details: dict, path: str = "bench-results/baselines/prev_round_details.json"
) -> None:
    """Store this run's details as the next run's regression baseline.

    The displaced baseline is archived under
    ``bench-results/baselines/archive/`` stamped with its own recorded
    device + a timestamp, so the full baseline history stays inspectable
    (the analog of Criterion's named ``--save-baseline`` snapshots,
    reference ``scripts/bench.sh:32-37``).
    """
    import os
    import shutil
    import time as _time

    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        arch = os.path.join(os.path.dirname(path), "archive")
        os.makedirs(arch, exist_ok=True)
        stamp = _time.strftime("%Y%m%d_%H%M%S")
        shutil.move(path, os.path.join(arch, f"details_{stamp}.json"))
    with open(path, "w") as f:
        json.dump(details, f, indent=2)
    print(f"[bench] baseline saved -> {path}", file=sys.stderr, flush=True)


def regression_report(
    details: dict, path: str = "bench-results/baselines/prev_round_details.json"
) -> dict:
    """Per-config deltas vs the previous run's stored BENCH_DETAILS.

    A config REGRESSES when its median slows by more than
    ``max(IQR_prev, IQR_now, 3% of prev)`` — i.e. beyond the measured
    dispersion of either run.

    Drift vs regression: when a flagged config's compiled-HLO fingerprint
    MATCHES the baseline's, the device ran the identical program both
    times and the delta is reclassified as ``drifted`` (environment), not
    ``regressed`` (code).  A fingerprint mismatch — or a baseline without
    fingerprints — keeps the conservative ``regressed`` flag.  A baseline
    recorded on another device kind is not compared at all.
    """
    import os

    if not os.path.exists(path):
        return {"baseline": None, "note": f"no stored baseline at {path}"}
    try:
        with open(path) as f:
            prev = json.load(f)
    except Exception as e:
        return {"baseline": path, "error": str(e)[:200]}
    if prev.get("device") != details.get("device"):
        return {
            "baseline": path,
            "note": f"baseline device {prev.get('device')} is not this run's; not compared",
        }
    prev_cfg = prev.get("configs") or {}
    rows: dict = {}
    regressed = []
    drifted = []
    for name, row in details["configs"].items():
        p = prev_cfg.get(name) or {}
        if "per_call_s" not in row or "per_call_s" not in p:
            continue
        cur, old = row["per_call_s"], p["per_call_s"]
        tol = max(row.get("iqr_s") or 0.0, p.get("iqr_s") or 0.0, 0.03 * old)
        delta_pct = 100.0 * (cur - old) / old
        reg = cur > old + tol
        entry = {
            "prev_us": old * 1e6,
            "delta_pct": round(delta_pct, 1),
            "regressed": reg,
        }
        if reg:
            fp_now, fp_prev = row.get("hlo_fp"), p.get("hlo_fp")
            if fp_now and fp_prev and fp_now == fp_prev:
                entry["regressed"] = False
                entry["drifted"] = True
                entry["note"] = (
                    "compiled HLO identical to baseline (fingerprint match) — "
                    "environment drift, not a code regression"
                )
                drifted.append(name)
            else:
                regressed.append(name)
        rows[name] = entry
    out = {
        "baseline": path,
        "baseline_device": prev.get("device"),
        "per_config": rows,
        "regressed": regressed,
        "drifted": drifted,
    }
    prev_head = (prev.get("headline") or {}).get("value")
    cur_head = (details["configs"].get("fft_n65536") or {}).get("melem_per_s")
    if prev_head and cur_head:
        out["headline_delta_pct"] = round(100.0 * (cur_head - prev_head) / prev_head, 1)
    if rows:
        worst = sorted(rows.items(), key=lambda kv: -kv[1]["delta_pct"])[:3]
        print(
            "[bench] vs prev round: "
            + " ".join(
                f"{n}:{'+' if r['delta_pct'] >= 0 else ''}{r['delta_pct']}%"
                + ("(REG)" if r["regressed"] else "")
                for n, r in worst
            )
            + (f"; headline {out.get('headline_delta_pct', '?')}%" if prev_head else ""),
            file=sys.stderr,
            flush=True,
        )
        if regressed:
            print(f"[bench] REGRESSED beyond IQR: {regressed}", file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    main()
