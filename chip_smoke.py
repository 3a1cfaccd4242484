"""Smoke run of gpu_fft_tpu on NVIDIA GPUs: the main path at real sizes, checked.

    python chip_smoke.py              # one GPU: every single-card phase
    python chip_smoke.py --chips 4    # four GPUs: only the sharded paths

Single-card phases: (1) the device, its power limit and the compile cache;
(2) the entry points a user calls (``python -m gpu_fft_tpu demo`` and
``backends`` in-process, the host API); (3) the device API at real sizes,
up to a batch larger than the card's L2 and n = 2^24.  There is no
hand-written kernel to check: every transform stage is plain jnp/lax that
XLA compiles.  Every result is compared with float64 numpy (on a
few sampled rows where the batch is large) and with ``jnp.fft`` on the card,
which is cuFFT, and each error is printed beside the bound it must meet.
Times are warm per-call host-clock times around ``block_until_ready``.

A failed check raises, so the script exits non-zero and the last line is
not printed.  On success the last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.  Without
a GPU the script fails at once.  It starts no process other than
``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np

EPS32 = float(np.finfo(np.float32).eps)


def gate(n: int) -> float:
    """The repo's accuracy bound for a length-n transform: 5*log2(n)*eps."""
    return 5.0 * float(np.log2(n)) * EPS32


def check(label: str, err: float, bound: float, why: str = "") -> None:
    ok = err <= bound
    print(f"  {label}: err {err:.3e} <= bound {bound:.3e}{f' ({why})' if why else ''}"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: error {err:.3e} exceeds bound {bound:.3e}")


def rel(a, b) -> float:
    """max|a - b| / max|b| over host arrays (float64)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def cplx_rel(yr, yi, ref) -> float:
    """max|y - ref| / max|ref| of a split-complex host result vs complex ``ref``."""
    err = max(np.abs(np.asarray(yr, np.float64) - ref.real).max(),
              np.abs(np.asarray(yi, np.float64) - ref.imag).max())
    return float(err / np.abs(ref).max())


def dev_rel(ar, ai, br, bi) -> float:
    """max|a - b| / max|b| of split-complex device arrays, reduced on device."""
    import jax.numpy as jnp

    num = jnp.maximum(jnp.max(jnp.abs(ar - br)), jnp.max(jnp.abs(ai - bi)))
    den = jnp.maximum(jnp.max(jnp.abs(br)), jnp.max(jnp.abs(bi)))
    return float(num / den)


@functools.cache
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def warm_us(f, *args, reps: int = 10) -> float:
    """Median warm per-call time, in µs, of ``f(*args)`` on the host clock."""
    import jax

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e6


def compiled(f, *args):
    """(``jit(f)``, kernel count of its compiled module at ``args``)."""
    import jax

    from gpu_fft_tpu.utils.roofline import kernel_stats

    jf = jax.jit(f)
    return jf, kernel_stats(jf.lower(*args).compile().as_text())["n_kernels"]


def peak_mib() -> float:
    import jax

    return jax.devices()[0].memory_stats()["peak_bytes_in_use"] / 2**20


# ── Phase 1: device ──────────────────────────────────────────────────────────


def phase_device(chips: int) -> dict:
    import jax

    from gpu_fft_tpu import config

    devs = jax.devices()
    d0 = devs[0]
    if len(devs) < chips:
        raise SystemExit(f"chip_smoke: --chips {chips} needs {chips} GPUs, found {len(devs)}")
    device = {"platform": d0.platform, "kind": d0.device_kind, "count": chips}
    print(f"[device] platform={d0.platform} kind={d0.device_kind} count={len(devs)}")
    print(f"[device] nvidia-smi: {card()}")
    print(f"[device] compile cache: {config.enable_compilation_cache()}")
    print(f"[device] precision mode: {config.PRECISION} "
          f"(lax.Precision.{config.matmul_precision().name} on every DFT matmul)", flush=True)
    return device


# ── Phase 2: entry points ────────────────────────────────────────────────────


def phase_entry_points() -> None:
    import gpu_fft_tpu as gf
    from gpu_fft_tpu.__main__ import main as cli

    print("[entry] python -m gpu_fft_tpu demo", flush=True)
    if cli(["demo"]) != 0:
        raise AssertionError("demo failed")
    print("[entry] python -m gpu_fft_tpu backends", flush=True)
    if cli(["backends"]) != 0:
        raise AssertionError("backends failed")
    print("[entry] host API: fft / ifft / fft_batch / ifft_batch", flush=True)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, 3000).astype(np.float32)  # zero-padded to 4096
    n = 4096
    re, im = gf.fft(x)
    ref = np.fft.fft(x.astype(np.float64), n)
    check("fft(host) vs float64", cplx_rel(re, im, ref), gate(n))
    out = gf.ifft(re, im)
    check("ifft(fft(x)) host roundtrip", float(np.abs(out[:3000] - x).max()), gate(n))
    sigs = [rng.uniform(-1, 1, m).astype(np.float32) for m in (1000, 4096, 2500)]
    spec = gf.fft_batch(sigs)
    for s, (r, i) in zip(sigs, spec):
        ref = np.fft.fft(s.astype(np.float64), n)
        check(f"fft_batch row len {len(s)} vs float64", cplx_rel(r, i, ref), gate(n))
    back = gf.ifft_batch(spec)
    for s, o in zip(sigs, back):
        check(f"ifft_batch row len {len(s)} roundtrip", float(np.abs(o[: len(s)] - s).max()), gate(n))


# ── Phase 3: main path at real sizes ─────────────────────────────────────────


def transform_case(b: int, n: int, rows: int = 4, full: bool = True) -> None:
    """fft/ifft (and, if ``full``, rfft/irfft and psd) of a (b, n) batch."""
    import jax
    import jax.numpy as jnp

    import gpu_fft_tpu as gf
    from gpu_fft_tpu.plan import describe_plan

    rng = np.random.default_rng(n + b)
    x = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    xd = jnp.asarray(x)
    sample = sorted({0, b // 2, b - 1} | set(rng.integers(0, b, max(rows - 3, 0)).tolist()))
    p = describe_plan(n, batch=b)
    print(f"[main] B={b} n={n} ({b * n * 4 / 2**20:.0f} MiB f32 in): path={p['path']} "
          f"split={p.get('split')} layout={p.get('layout')}", flush=True)
    bound = gate(n)

    fwd, nk = compiled(gf.fft_device, xd)
    yr, yi = fwd(xd)
    ref = np.fft.fft(x[sample].astype(np.float64), axis=-1)
    rows_d = jnp.asarray(sample)
    check("fft_device vs float64 (sampled rows)", cplx_rel(yr[rows_d], yi[rows_d], ref), bound)
    cu_exe, cu_nk = compiled(lambda v: jnp.fft.fft(v.astype(jnp.complex64)), xd)
    c = cu_exe(xd)
    check("fft_device vs cuFFT (all rows)", dev_rel(yr, yi, jnp.real(c), jnp.imag(c)), bound)
    del c

    inv, _ = compiled(gf.ifft_device, yr, yi)
    zr, zi = inv(yr, yi)
    check("ifft_device(fft_device(x)) - x", float(jnp.max(jnp.abs(zr - xd))), bound)
    check("imag of the roundtrip", float(jnp.max(jnp.abs(zi))), bound)
    t_f = warm_us(fwd, xd)
    t_c = warm_us(cu_exe, xd)
    t_i = warm_us(inv, yr, yi)
    del zr, zi
    line = (f"  time: fft_device {t_f:.1f} us ({nk} kernels), cuFFT fft {t_c:.1f} us "
            f"({cu_nk} kernels), ifft_device {t_i:.1f} us")
    if full:
        rf, _ = compiled(gf.rfft_device, xd)
        hr, hi = rf(xd)
        irf, _ = compiled(gf.irfft_device, hr, hi)
        back = irf(hr, hi)
        check("irfft_device(rfft_device(x)) - x", float(jnp.max(jnp.abs(back - xd))), bound)
        ps, _ = compiled(gf.psd_device, yr, yi)
        pw = ps(yr, yi)
        pref = np.abs(ref) ** 2 / n
        check("psd_device vs float64 (sampled rows)", rel(pw[rows_d], pref),
              2 * bound, "|X|^2 doubles the forward relative error")
        line += f", rfft_device {warm_us(rf, xd):.1f} us, irfft_device {warm_us(irf, hr, hi):.1f} us"
        del hr, hi, back, pw
    del yr, yi
    print(f"{line}; peak {peak_mib():.0f} MiB; card {card()}", flush=True)


def grad_case(n: int) -> None:
    import jax
    import jax.numpy as jnp

    import gpu_fft_tpu as gf

    print(f"[main] jax.grad of sum|FFT(x)|^2 at n={n} (the linear_call seam)", flush=True)
    x = np.random.default_rng(7).uniform(-1, 1, (1, n)).astype(np.float32)
    xd = jnp.asarray(x)

    def power(v):
        yr, yi = gf.fft_device(v)
        return jnp.sum(yr * yr + yi * yi)

    def power_cufft(v):
        c = jnp.fft.fft(v.astype(jnp.complex64))
        return jnp.sum(jnp.real(c * jnp.conj(c)))

    g, nk = compiled(jax.grad(power), xd)
    gc, _ = compiled(jax.grad(power_cufft), xd)
    got = g(xd)
    # Parseval: sum|X|^2 = n sum x^2, so the gradient is exactly 2 n x.
    check("grad vs 2*n*x (float64)", rel(np.asarray(got), 2.0 * n * x.astype(np.float64)), gate(n),
          "forward + transposed transform, a roundtrip's error")
    check("grad vs grad through cuFFT", rel(np.asarray(got), np.asarray(gc(xd))), gate(n))
    print(f"  time: grad {warm_us(g, xd):.1f} us ({nk} kernels), through cuFFT "
          f"{warm_us(gc, xd):.1f} us; peak {peak_mib():.0f} MiB; card {card()}", flush=True)


def fft2_case(h: int, w: int) -> None:
    import jax.numpy as jnp

    import gpu_fft_tpu as gf

    print(f"[main] fft2_device {h}x{w}", flush=True)
    x = np.random.default_rng(h).uniform(-1, 1, (h, w)).astype(np.float32)
    xd = jnp.asarray(x)
    f, nk = compiled(gf.fft2_device, xd)
    yr, yi = f(xd)
    ref = np.fft.fft2(x.astype(np.float64))
    check("fft2_device vs float64", cplx_rel(yr, yi, ref), gate(h * w))
    cu, cnk = compiled(lambda v: jnp.fft.fft2(v.astype(jnp.complex64)), xd)
    c = cu(xd)
    check("fft2_device vs cuFFT", dev_rel(yr, yi, jnp.real(c), jnp.imag(c)), gate(h * w))
    inv, _ = compiled(gf.ifft2_device, yr, yi)
    zr, _ = inv(yr, yi)
    check("ifft2_device(fft2_device(x)) - x", float(jnp.max(jnp.abs(zr - xd))), gate(h * w))
    print(f"  time: fft2_device {warm_us(f, xd):.1f} us ({nk} kernels), cuFFT fft2 "
          f"{warm_us(cu, xd):.1f} us ({cnk} kernels); peak {peak_mib():.0f} MiB; card {card()}", flush=True)


def exact_case(n: int) -> None:
    import jax.numpy as jnp

    import gpu_fft_tpu as gf
    from gpu_fft_tpu.ops.exact import mixed_split

    sp = mixed_split(n)
    print(f"[main] fft_exact_device n={n} (mixed-radix split {sp})", flush=True)
    x = np.random.default_rng(n).uniform(-1, 1, (1, n)).astype(np.float32)
    xd = jnp.asarray(x)
    f, nk = compiled(gf.fft_exact_device, xd)
    yr, yi = f(xd)
    ref = np.fft.fft(x.astype(np.float64))
    check("fft_exact_device vs float64", cplx_rel(yr, yi, ref), gate(n))
    cu, cnk = compiled(lambda v: jnp.fft.fft(v.astype(jnp.complex64)), xd)
    c = cu(xd)
    check("fft_exact_device vs cuFFT", dev_rel(yr, yi, jnp.real(c), jnp.imag(c)), gate(n))
    print(f"  time: fft_exact_device {warm_us(f, xd):.1f} us ({nk} kernels), cuFFT "
          f"{warm_us(cu, xd):.1f} us ({cnk} kernels); card {card()}", flush=True)


def stft_welch_case(length: int, frame: int, hop: int) -> None:
    import jax
    import jax.numpy as jnp
    import scipy.signal as ss

    import gpu_fft_tpu as gf
    from gpu_fft_tpu.ops.stft import window_table

    x = np.random.default_rng(5).uniform(-1, 1, length).astype(np.float32)
    xd = jnp.asarray(x)
    print(f"[main] STFT {frame}/{hop} round trip and Welch({frame}) on {length} samples", flush=True)
    w = window_table("hann", frame)
    nf = (length - frame) // hop + 1
    idx = np.arange(nf)[:, None] * hop + np.arange(frame)[None]
    st, nk = compiled(lambda v: gf.stft_device(v, frame, hop=hop), xd)
    sr, si = st(xd)
    ref = np.fft.rfft(x[idx].astype(np.float64) * w.astype(np.float64), axis=-1)
    check("stft_device vs float64", cplx_rel(sr, si, ref), gate(frame))
    cu = jax.jit(lambda v: jnp.fft.rfft(v[jnp.asarray(idx)] * jnp.asarray(w)))(xd)
    check("stft_device vs cuFFT", dev_rel(sr, si, jnp.real(cu), jnp.imag(cu)), gate(frame))
    ist, _ = compiled(lambda r, i: gf.istft_device(r, i, hop=hop, length=length), sr, si)
    back = np.asarray(ist(sr, si))
    cov = slice(frame, length - frame)  # samples covered by full window overlap
    check("istft_device(stft_device(x)) - x (covered samples)",
          float(np.abs(back[cov] - x[cov]).max()), gate(frame))
    we, wnk = compiled(lambda v: gf.welch_device(v, nperseg=frame)[1], xd)
    p = np.asarray(we(xd))
    _, pref = ss.welch(x.astype(np.float64), nperseg=frame)
    check("welch_device vs scipy.signal.welch (float64)", rel(p, pref), 2 * gate(frame),
          "power doubles the forward relative error")
    print(f"  time: stft {warm_us(st, xd):.1f} us ({nk} kernels), istft {warm_us(ist, sr, si):.1f} us, "
          f"welch {warm_us(we, xd):.1f} us ({wnk} kernels); card {card()}", flush=True)


MAIN_SIZES = {
    "single": (1024, 4096, 16384, 65536, 1 << 20, 1 << 22, 1 << 24),
    "batched": ((16, 65536), (64, 4096)),
    "beyond_l2": (64, 1 << 20),  # 256 MiB of f32 input: beyond the 50 MB L2
    "grad": 1 << 20,
    "fft2": ((256, 512), (4096, 4096)),
    "exact": 48000,
    "stft": (65536, 256, 64),
}


def phase_main(sizes=MAIN_SIZES) -> None:
    for n in sizes["single"]:
        transform_case(1, n)
    for b, n in sizes["batched"]:
        transform_case(b, n)
    transform_case(*sizes["beyond_l2"], full=False)
    grad_case(sizes["grad"])
    for h, w in sizes["fft2"]:
        fft2_case(h, w)
    exact_case(sizes["exact"])
    stft_welch_case(*sizes["stft"])


# ── Phase 4: four cards ──────────────────────────────────────────────────────


def spread(a, label: str) -> None:
    """Fail unless ``a`` lives on all four devices (not gathered onto one)."""
    devs = {s.device for s in a.addressable_shards}
    if len(devs) != 4:
        raise AssertionError(f"{label}: output on {len(devs)} devices, not 4")
    how = "replicated on" if a.sharding.is_fully_replicated else "sharded over"
    print(f"  {label}: output {how} {len(devs)} devices", flush=True)


FOUR_CARD_SIZES = {
    "batch": (64, 65536),
    "distributed": (1 << 20, 1 << 24),
    "fft2": 8192,
    "welch": 1 << 24,
    "oaconvolve": 1 << 22,
    "lfilter": 1 << 20,
}


def phase_four_cards(sizes=FOUR_CARD_SIZES) -> None:
    import jax
    import jax.numpy as jnp
    import scipy.signal as ss
    from jax.sharding import Mesh

    import gpu_fft_tpu as gf
    from gpu_fft_tpu.parallel import (
        distributed_fft,
        distributed_ifft,
        fft2_sharded,
        fft_batch_sharded,
        ifft2_sharded,
        ifft_batch_sharded,
        lfilter_sharded,
        oaconvolve_sharded,
        welch_sharded,
    )

    devs = jax.devices()[:4]
    mesh = Mesh(np.asarray(devs), ("x",))
    one = devs[0]
    rng = np.random.default_rng(4)

    def on_one(a):
        return jax.device_put(a, one)

    b, n = sizes["batch"]
    print(f"[4 cards] fft_batch_sharded / ifft_batch_sharded B={b} n={n}", flush=True)
    x = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    yr, yi = jax.jit(lambda v: fft_batch_sharded(v, mesh, axis_name="x"))(jnp.asarray(x))
    spread(yr, "fft_batch_sharded")
    sr, si = gf.fft_device(on_one(x))
    check("sharded vs one card", dev_rel(on_one(yr), on_one(yi), sr, si), gate(n))
    ref = np.fft.fft(x[:2].astype(np.float64))
    check("sharded vs float64 (rows 0-1)", cplx_rel(yr[:2], yi[:2], ref), gate(n))
    zr, _ = jax.jit(lambda r, i: ifft_batch_sharded(r, i, mesh, axis_name="x"))(yr, yi)
    spread(zr, "ifft_batch_sharded")
    check("ifft_batch_sharded roundtrip", float(np.abs(np.asarray(zr) - x).max()), gate(n))

    for n in sizes["distributed"]:
        print(f"[4 cards] distributed_fft / distributed_ifft n={n}", flush=True)
        x = rng.uniform(-1, 1, (1, n)).astype(np.float32)
        f = jax.jit(lambda v: distributed_fft(v, mesh, sp_axis="x"))
        yr, yi = f(jnp.asarray(x))
        spread(yr, "distributed_fft")
        sr, si = gf.fft_device(on_one(x))
        check("distributed vs one card", dev_rel(on_one(yr), on_one(yi), sr, si), gate(n))
        ref = np.fft.fft(x[0].astype(np.float64))
        check("distributed vs float64", cplx_rel(yr[0], yi[0], ref), gate(n))
        g = jax.jit(lambda r, i: distributed_ifft(r, i, mesh, sp_axis="x"))
        zr, _ = g(yr, yi)
        spread(zr, "distributed_ifft")
        check("distributed roundtrip", float(np.abs(np.asarray(zr) - x).max()), gate(n))
        t1 = warm_us(gf.fft_device, on_one(x))
        t4 = warm_us(f, jnp.asarray(x))
        print(f"  time: distributed_fft {t4:.1f} us on 4 cards, fft_device {t1:.1f} us on one; "
              f"card {card()}", flush=True)

    h = w = sizes["fft2"]
    print(f"[4 cards] fft2_sharded / ifft2_sharded {h}x{w} (pencil all-to-all)", flush=True)
    x = rng.uniform(-1, 1, (h, w)).astype(np.float32)
    f = jax.jit(lambda v: fft2_sharded(v, mesh, sp_axis="x"))
    yr, yi = f(jnp.asarray(x))
    spread(yr, "fft2_sharded")
    sr, si = gf.fft2_device(on_one(x))
    check("fft2_sharded vs one card", dev_rel(on_one(yr), on_one(yi), sr, si), gate(h * w))
    del sr, si
    ref = np.fft.fft2(x.astype(np.float64))
    check("fft2_sharded vs float64", cplx_rel(yr, yi, ref), gate(h * w))
    del ref
    g = jax.jit(lambda r, i: ifft2_sharded(r, i, mesh, sp_axis="x"))
    zr, _ = g(yr, yi)
    spread(zr, "ifft2_sharded")
    check("fft2_sharded roundtrip", float(np.abs(np.asarray(zr) - x).max()), gate(h * w))
    t4 = warm_us(f, jnp.asarray(x))
    t1 = warm_us(gf.fft2_device, on_one(x))
    print(f"  time: fft2_sharded {t4:.1f} us on 4 cards, fft2_device {t1:.1f} us on one; card {card()}",
          flush=True)

    length = sizes["welch"]
    print(f"[4 cards] welch_sharded nperseg=256 on {length} samples", flush=True)
    x = rng.uniform(-1, 1, length).astype(np.float32)
    _, p4 = welch_sharded(jnp.asarray(x), mesh, axis_name="x", nperseg=256)
    _, p1 = gf.welch_device(on_one(x), nperseg=256)
    check("welch_sharded vs one card", rel(np.asarray(p4), np.asarray(p1)), 2 * gate(256))
    _, pref = ss.welch(x.astype(np.float64), nperseg=256)
    check("welch_sharded vs scipy (float64)", rel(np.asarray(p4), pref), 2 * gate(256),
          "power doubles the forward relative error")

    length = sizes["oaconvolve"]
    print(f"[4 cards] oaconvolve_sharded 257 taps on {length} samples", flush=True)
    x = rng.uniform(-1, 1, length).astype(np.float32)
    taps = rng.uniform(-1, 1, 257).astype(np.float32)
    c4 = jax.jit(lambda v: oaconvolve_sharded(v, jnp.asarray(taps), mesh, axis_name="x"))(jnp.asarray(x))
    spread(c4, "oaconvolve_sharded")
    c1 = gf.oaconvolve_device(on_one(x), on_one(taps))
    check("oaconvolve_sharded vs one card", rel(np.asarray(c4), np.asarray(c1)), gate(1 << 14))
    cref = ss.oaconvolve(x.astype(np.float64), taps.astype(np.float64))
    check("oaconvolve_sharded vs scipy (float64)", rel(np.asarray(c4), cref), gate(1 << 14),
          "bound of the 2^14-point block transform")

    length = sizes["lfilter"]
    print(f"[4 cards] lfilter_sharded butter(4, 0.2) on {length} samples", flush=True)
    bb, aa = ss.butter(4, 0.2)
    x = rng.uniform(-1, 1, length).astype(np.float32)
    y4 = jax.jit(lambda v: lfilter_sharded(bb, aa, v, mesh, axis_name="x"))(jnp.asarray(x))
    spread(y4, "lfilter_sharded")
    y1 = gf.lfilter_device(bb, aa, on_one(x))
    y1 = y1[0] if isinstance(y1, tuple) else y1
    yref = ss.lfilter(bb, aa, x.astype(np.float64))
    why = "f32 IIR recursion; the tolerance of __graft_entry__.dryrun_multichip"
    check("lfilter_sharded vs one card", rel(np.asarray(y4), np.asarray(y1)), 5e-5, why)
    check("lfilter_sharded vs scipy (float64)", rel(np.asarray(y4), yref), 5e-5, why)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4 runs only the sharded paths on four GPUs")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {jax.devices()[0].platform!r})", file=sys.stderr)
        return 2
    import gpu_fft_tpu  # noqa: F401  (fails here when run outside a checkout)

    t0 = time.time()
    device = phase_device(args.chips)
    if args.chips == 4:
        phase_four_cards()
    else:
        phase_entry_points()
        phase_main()
    print(f"[done] {time.time() - t0:.0f} s")
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
