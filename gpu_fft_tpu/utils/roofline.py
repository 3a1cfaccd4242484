"""Device peaks and roofline accounting per benchmark config.

One table, :data:`CHIPS`, holds the published peaks of each device the
library runs on, keyed by :func:`device_key` (JAX's ``platform`` and
``device_kind``).  A device that is not in the table is an error, not a
default.  :func:`transform_cost` counts the FLOPs and the bytes the
algorithm needs for one config, mirroring the live dispatch
(``kernels/large.py``); :func:`roofline_row` divides them by the peak that
matches the precision mode and by the memory bandwidth, and reports the
larger as the least time the device could take.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..config import DIRECT_MAX, FUSED_MAX

__all__ = [
    "ChipSpec",
    "CHIPS",
    "chip_key",
    "device_key",
    "detect_chip",
    "transform_cost",
    "roofline_row",
    "compiled_stats",
    "kernel_stats",
]


@dataclass(frozen=True)
class ChipSpec:
    name: str
    fp32_tflops: float  # float32 outside the tensor cores
    tf32_tflops: float  # TF32 tensor cores, dense
    bf16_tflops: float  # bf16 tensor cores, dense
    hbm_gbps: float  # device-memory bandwidth, GB/s
    l2_mb: float  # last-level cache, MB
    source: str


CHIPS = {
    "h100": ChipSpec(
        "h100", 67.0, 495.0, 989.0, 3350.0, 50.0,
        "NVIDIA H100 SXM data sheet: dense rates without sparsity, at the "
        "700 W power limit",
    ),
    # Used only by the CPU test mesh so the accounting stays defined there.
    "cpu": ChipSpec(
        "cpu", 1.0, 1.0, 1.0, 50.0, 0.0,
        "nominal placeholder for the CPU test mesh, not a measurement",
    ),
}

# Which peak a precision mode's f32 matmuls run at on the GPU
# (config.PRECISION; lax.Precision.HIGHEST is fp32 outside the tensor cores).
PRECISION_PEAK = {"full": "fp32", "high": "tf32", "fast": "tf32"}


def chip_key(platform: str, device_kind: str) -> str:
    """The :data:`CHIPS` key of a device, or ValueError if it has none."""
    kind = (device_kind or "").lower()
    if platform == "gpu" and "h100" in kind:
        return "h100"
    if platform == "cpu":
        return "cpu"
    raise ValueError(
        f"no device-table row for platform={platform!r} device_kind={device_kind!r}"
    )


def device_key() -> str:
    """:func:`chip_key` of JAX's default device."""
    import jax

    d = jax.devices()[0]
    return chip_key(d.platform, d.device_kind)


def detect_chip() -> ChipSpec:
    """The peaks of JAX's default device (ValueError if it is unknown)."""
    return CHIPS[device_key()]


def kernel_stats(hlo_text: str) -> dict:
    """Kernel count + content fingerprint of a compiled HLO module's text.

    ``n_kernels`` counts the instructions that launch device work on the
    GPU: fusions (XLA's own kernels, Triton GEMM fusions included), custom
    calls (cuBLAS GEMMs and other library calls) and ``fft`` instructions
    (cuFFT).  ``fingerprint`` is a sha256 prefix of the text: two runs with
    the same fingerprint ran the identical program.
    """
    import hashlib
    import re

    txt = hlo_text
    fusions = len(re.findall(r"\sfusion\(", txt))
    custom = len(re.findall(r"\scustom-call\(", txt))
    ffts = len(re.findall(r"\sfft\(", txt))
    return {
        "n_kernels": fusions + custom + ffts,
        "n_fusions": fusions,
        "n_custom_calls": custom,
        "n_fft": ffts,
        "fingerprint": hashlib.sha256(txt.encode()).hexdigest()[:16],
    }


def compiled_stats(step, x0) -> dict:
    """:func:`kernel_stats` of ``jit(step)(x0)``'s compiled module."""
    import jax

    return kernel_stats(jax.jit(step).lower(x0).compile().as_text())


def _fused_split(n: int, b: int) -> tuple[int, int]:
    """The (wide-batch aware) fused factorization transform_any will use."""
    from ..plan import fused_split

    return fused_split(n, b)


def _stage_a_n1(n: int) -> int:
    from ..plan import _stage_a_n1 as f

    return f(n)


def _pack_applies(b: int, n: int) -> bool:
    from ..plan import rfft_pack_applies

    return rfft_pack_applies(b, n)


def _half_applies(n: int) -> bool:
    from ..plan import half_spectrum_applies

    return half_spectrum_applies(n)


def transform_stages(b: int, n: int, real_input: bool):
    """Per-matmul-stage (flops, contraction) list + elementwise flops.

    Mirrors the live dispatch (``kernels/large.py:transform_any``): the
    real-input packing gate, direct/fourstep/staged planning, and the
    Karatsuba 3-dot complex matmuls.  A real matmul (m, k) @ (k, j) counts
    2*m*k*j; a complex elementwise multiply 6 flops/element.
    """
    if real_input and n >= 8 and _pack_applies(b, n):
        stages, elem = transform_stages(b, n // 2, real_input=False)
        # Packed recombination: mirror/E/O/T/X epilogue, ~8 flops per
        # original element.
        return stages, elem + 8.0 * b * n
    if n <= DIRECT_MAX:
        if real_input:
            return [(2 * 2.0 * b * n * n, n)], 0.0
        return [(3 * 2.0 * b * n * n, n)], 7.0 * b * n
    if n <= FUSED_MAX:
        if real_input and _half_applies(n):
            # Hermitian half-spectrum route (kernels/fused_jnp.py:
            # fused_fft_jnp_half): balanced split, full first stage, then
            # only h = n1/2 + 1 k1-rows survive — the second matmul, the
            # twiddle and the stage-2 epilogue all scale by h/n1; one
            # rev+concat mirror epilogue (~2 flops/elem charged).
            from ..plan import balanced_split

            n1, n2 = balanced_split(n)
            frac = (n1 // 2 + 1) / n1
            stages = [
                (2 * 2.0 * b * n * n1, n1),
                (3 * 2.0 * b * n * n2 * frac, n2),
            ]
            elem = (6.0 + 5.0) * b * n * frac + 2.0 * b * n
            return stages, elem
        n1, n2 = _fused_split(n, b)
        stages = []
        if real_input:
            stages.append((2 * 2.0 * b * n * n1, n1))
            elem = 6.0 * b * n
        else:
            stages.append((3 * 2.0 * b * n * n1, n1))
            elem = 6.0 * b * n + 5.0 * b * n
        stages.append((3 * 2.0 * b * n * n2, n2))
        elem += 5.0 * b * n
        return stages, elem
    n1 = _stage_a_n1(n)
    n2 = n // n1
    half = real_input and _half_applies(n)
    # Row-limited stage A (kernels/large.py:_stage_a rows=...): the real
    # staged half path computes only n1/2 + 1 k1 rows.
    frac_a = (n1 // 2 + 1) / n1 if half else 1.0
    if real_input:
        stages = [(2 * 2.0 * b * n * n1 * frac_a, n1)]
        elem = 6.0 * b * n * frac_a
    else:
        stages = [(3 * 2.0 * b * n * n1, n1)]
        elem = 6.0 * b * n + 5.0 * b * n
    s2, e2 = transform_stages(b * n1, n2, real_input=False)
    if half:
        # Staged half route (stage_b_half_jnp): the k1 axis is sliced to
        # h = n1/2 + 1 rows before stage B, so every stage-B matmul and
        # epilogue scales by h/n1, plus the mirror.
        frac = (n1 // 2 + 1) / n1
        s2 = [(f * frac, k) for f, k in s2]
        e2 = e2 * frac + 2.0 * b * n
    return stages + s2, elem + e2


def irfft_stages(b: int, n: int):
    """Stage list for the real-OUTPUT inverse (``kernels/large.py:
    inverse_real``), mirroring its dispatch: the fused Hermitian fold at
    irfft_half_min <= n <= FUSED_MAX, the half-column stage A + per-row
    stage-B fold at n >= irfft_half_staged_min, and the full complex
    inverse + drop-imag otherwise.  Returns (stages, elem_flops,
    read_fraction) — the fold reads only its kept fraction of the input
    spectrum, which the byte charge must reflect to keep pct_sol <= 100.
    """
    from ..plan import balanced_split, irfft_half_applies, irfft_half_staged_applies

    if n <= FUSED_MAX and n >= 16 and irfft_half_applies(n):
        n1, n2 = balanced_split(n)
        h1 = n1 // 2 + 1
        stages = [
            # Stage 1: Karatsuba complex contraction of k2 over h1 columns.
            (3 * 2.0 * b * h1 * n2 * n2, n2),
            # Stage 2: two REAL einsums contracting n1/2, natural order out.
            (2 * 2.0 * b * n * (n1 // 2), n1 // 2),
        ]
        elem = 6.0 * b * h1 * n2 + 2.0 * b * n  # twiddle + Nyquist broadcast
        return stages, elem, h1 / n1
    if n > FUSED_MAX and irfft_half_staged_applies(n):
        n1 = _stage_a_n1(n)
        n2 = n // n1
        from ..plan import stage_a_col_tile

        ct = stage_a_col_tile(n2)
        w = -(-(n2 // 2 + 1) // ct) * ct  # computed stage-A columns
        P, q = n2 // 128, 128
        h = q // 2 + 1
        stages = [
            # Half-column complex stage A (Karatsuba).
            (3 * 2.0 * b * n1 * n1 * w, n1),
            # Per-row stage-B fold: complex stage 1 over h of q minor cols.
            (3 * 2.0 * b * n1 * h * P * P, P),
            # Real-only stage 2 contracting q/2.
            (2 * 2.0 * b * n * (q // 2), q // 2),
        ]
        # stage-A twiddle + fold-input reversal passes + row twiddle.
        elem = 6.0 * b * n1 * w + 2.0 * b * n + 6.0 * b * n1 * h * P
        return stages, elem, w / n2
    stages, elem = transform_stages(b, n, real_input=False)
    return stages, elem, 1.0


def transform_flops(b: int, n: int, real_input: bool) -> float:
    """Total algorithm FLOPs (matmul + elementwise) of one planned transform."""
    stages, elem = transform_stages(b, n, real_input)
    return sum(f for f, _ in stages) + elem


def transform_cost(b: int, n: int, kind: str = "fft") -> dict:
    """FLOPs + speed-of-light bytes + per-stage classes for one config.

    ``kind``: fft (real in, split-complex out), ifft (complex in/out),
    roundtrip (fft + ifft), fft_sequential (same work as fft), plus the
    analysis-op kinds (see the table below).
    """
    f32 = 4

    def parts(*specs):
        stages: list = []
        elem = 0.0
        for bb, nn, real in specs:
            s, e = transform_stages(bb, nn, real)
            stages += s
            elem += e
        return stages, elem

    if kind in ("fft", "fft_batch", "fft_sequential", "fft_batchsize", "welch"):
        # welch: (b, n) = (segments, nperseg); the window/mean epilogue is
        # O(bn) and excluded, so the SoL stays a true lower bound.
        stages, elem = parts((b, n, True))
        bytes_ = b * n * f32 * (1 + 2)  # read x, write (re, im)
    elif kind in ("ifft", "ifft_batch", "ifft_sequential"):
        stages, elem = parts((b, n, False))
        elem += 2.0 * b * n  # 1/N scale
        bytes_ = b * n * f32 * (2 + 2)
    elif kind == "irfft":
        # Real-output inverse (inverse_real): Hermitian-fold dispatch; the
        # fold reads only its kept fraction of the spectrum and the 1/N
        # scale lives in the plan tables (no extra pass).
        stages, elem, read_frac = irfft_stages(b, n)
        bytes_ = b * n * f32 * (2.0 * read_frac + 1)
    elif kind in (
        "roundtrip",
        "roundtrip_batch",
        "roundtrip_sequential",
        # Analysis ops that are a forward + inverse pair over their (b, n):
        # hilbert (fft -> gain mask -> ifft; the analytic output is genuinely
        # complex, so the inverse leg is the full complex transform).
        "hilbert",
        # grad_fft: reverse-mode spectrum-power gradient = the forward
        # transform + its transpose (conj . T . conj — one full COMPLEX
        # transform via the linear_call seam, kernels/large.py) + an O(bn)
        # epilogue — a roundtrip's compute, so the roundtrip model is its
        # speed-of-light.
        "grad_fft",
    ):
        stages, elem = parts((b, n, True), (b, n, False))
        elem += 2.0 * b * n
        bytes_ = b * n * f32 * (1 + 2)  # x in, (re,im) of the roundtrip out
    elif kind == "dct_roundtrip":
        # Orthonormal dct+idct (ops/dct.py): Makhoul forward = real FFT @ n
        # + rotation; DCT-III inverse rides the real-OUTPUT inverse dispatch
        # (kernels/large.py:inverse_real — full complex below irfft_half_min,
        # Hermitian fold above), so the inverse leg is the irfft charge.
        # The permutation matmuls are pure data movement (a zero-FLOP
        # permutation in principle), so they are not charged — the SoL stays
        # a true lower bound.
        stages, elem = parts((b, n, True))
        s2, e2, _ = irfft_stages(b, n)
        stages += s2
        elem += e2 + 4.0 * b * n  # pre/post rotations
        bytes_ = b * n * f32 * (1 + 2)
    elif kind == "resample":
        # The benched step is resample(resample(x, n/2), n) — down then back
        # up: real forward @ n, one-sided inverse @ n/2, real forward @ n/2,
        # one-sided inverse @ n (ops/dsp.py:resample_device rides
        # inverse_real_half for pow2 targets).  Spectrum surgery is O(bn) elementwise.
        mid = n // 2
        stages, elem = parts((b, n, True), (b, mid, True))
        for target in (mid, n):
            s2, e2, _ = irfft_stages(b, target)
            stages += s2
            elem += e2
        elem += 4.0 * b * n
        bytes_ = b * n * f32 * (1 + 1)
    elif kind == "stft_roundtrip":
        # STFT analysis + synthesis over (frames, frame_size): forward real
        # frames, then the one-sided inverse (istft -> irfft_device ->
        # inverse_real_half).  At direct frame sizes the inverse is two real
        # dots contracting h = n//2 + 1 bins (the Hermitian fold lives in
        # the tables); larger frames mirror + run the fold dispatch, the
        # same charge as a full roundtrip.
        if n <= DIRECT_MAX:
            stages, elem = parts((b, n, True))
            h = n // 2 + 1
            # Direct inverse leg: the K = n/2 variant (K = n/2 dots +
            # Nyquist broadcast) when its gate is on, else the
            # h-deep fold (kernels/large.py:inverse_real_half).
            from ..tuning import get_tuning

            if n >= 256 and get_tuning().irfft_direct_k128:
                stages.append((2 * 2.0 * b * n * (n // 2), n // 2))
            else:
                stages.append((2 * 2.0 * b * n * h, h))
            # window multiply + overlap-add accumulation + WOLA division.
            elem += 4.0 * b * n
        else:
            stages, elem = parts((b, n, True), (b, n, False))
            elem += 2.0 * b * n
        bytes_ = b * n * f32 * (1 + 2)
    elif kind in ("oaconvolve", "fftfilt"):
        # Overlap-add FIR: (b, n) = (blocks, block transform length m).
        # Forward real blocks + spectrum product + inverse complex + 1/m.
        stages, elem = parts((b, n, True), (b, n, False))
        elem += 8.0 * b * n
        bytes_ = b * n * f32 * (1 + 1)  # real blocks in, real blocks out
    elif kind == "conv2d":
        # 2-D FFT convolution of ONE image via the one-sided (rfft2) path:
        # (b, n) = padded (m1, m2).  Forward: real rows + complex cols over
        # the n//2+1 surviving bins; inverse: cols over the half-spectrum +
        # full complex rows (Hermitian reconstruction); kernel spectrum
        # amortized.
        hw = n // 2 + 1
        stages, elem = parts((b, n, True), (hw, b, False), (hw, b, False))
        if n <= DIRECT_MAX:
            # Row inverse from the one-sided bins: irfft_device ->
            # inverse_real_half = two real dots contracting hw (the
            # Hermitian fold lives in the tables).
            stages.append((2 * 2.0 * b * n * hw, hw))
        else:
            s2, e2 = parts((b, n, False))
            stages += s2
            elem += e2
        elem += 8.0 * b * hw
        bytes_ = b * n * f32 * (1 + 1)
    elif kind == "fft2":
        # b here means H (rows) and n means W: row pass + column pass.
        stages, elem = parts((b, n, True), (n, b, False))
        bytes_ = b * n * f32 * (1 + 2)
    elif kind == "fft_exact":
        # Exact non-pow2 dispatch (ops/exact.py): mixed-radix four-step
        # (two direct-digit matmuls + twiddle; real input skips the first
        # stage's third dot) when a balanced divisor pairing wins on
        # modeled FLOPs, else Bluestein's two complex pow2 transforms of
        # length m plus chirp multiplies.  b carries the batch, n the
        # (arbitrary) length.
        from ..ops.exact import mixed_split

        sp = mixed_split(n)
        if sp is not None:
            n1, n2 = sp
            stages = [
                (2 * 2.0 * b * n * n1, n1),  # real input: two stage-1 dots
                (3 * 2.0 * b * n * n2, n2),
            ]
            elem = 6.0 * b * n  # twiddle
        else:
            m = 1
            while m < 2 * n - 1:
                m *= 2
            stages, elem = parts((b, m, False), (b, m, False))
            elem += 3 * 6.0 * b * n
        bytes_ = b * n * f32 * (1 + 2)
    else:
        raise ValueError(f"unknown config kind {kind!r}")
    return {
        "flops": sum(f for f, _ in stages) + elem,
        "bytes": bytes_,
        "stages": stages,
        "elem_flops": elem,
    }


def roofline_row(
    b: int,
    n: int,
    kind: str,
    measured_s: float,
    chip: ChipSpec | None = None,
    precision: str | None = None,
) -> dict:
    """Roofline share of a measured config.

    The least time is the larger of the algorithm's FLOPs over the peak that
    matches the precision mode (``precision``, default ``config.PRECISION``;
    see :data:`PRECISION_PEAK`) and its bytes over the device-memory
    bandwidth; ``bound`` names which.  ``pct_sol`` is that least time over
    the measured one.
    """
    from .. import config

    chip = chip or detect_chip()
    mode = precision or config.PRECISION
    peak = {"fp32": chip.fp32_tflops, "tf32": chip.tf32_tflops}[PRECISION_PEAK[mode]]
    cost = transform_cost(b, n, kind)
    walls = {
        "compute": cost["flops"] / (peak * 1e12),
        "hbm": cost["bytes"] / (chip.hbm_gbps * 1e9),
    }
    bound = max(walls, key=walls.get)
    sol = walls[bound]
    return {
        "flops": cost["flops"],
        "bytes": cost["bytes"],
        "sol_us": sol * 1e6,
        "pct_sol": 100.0 * sol / measured_s if measured_s > 0 else 0.0,
        "bound": bound,
        "chip": chip.name,
        "precision": mode,
        "peak_tflops": peak,
    }
