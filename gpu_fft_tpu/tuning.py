"""Per-device dispatch constants (the tuning table).

Every dispatch predicate — the wide-split and folded-layout rules, the
stage-A digit, the real-input gates, the overlap-add block size — reads its
threshold from one :class:`ChipTuning` row, keyed by the device table in
``utils/roofline.py`` (``device_key``).  A device without a row is an
error, not a default.

The reference's analog is its compile-time tuning constants
(``WORKGROUP_SIZE``/``TILE_SIZE``/``TILE_BITS``, reference
``src/lib.rs:100-111``) — fixed for one GPU class.

``calibrated`` says whether the row's values were measured on that device.
The ``h100`` row is not calibrated: its values were carried over from the
accelerator the library was first tuned on and have not been measured on the
H100 (ROADMAP queue 1.5 lists each field).  The ``cpu`` row mirrors ``h100``
so that the CPU test mesh takes the GPU's dispatch decisions.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, replace

__all__ = ["ChipTuning", "TUNING", "get_tuning"]


@dataclass(frozen=True)
class ChipTuning:
    """Dispatch constants for one device.

      * ``wide_batch_min`` / ``wide_n_min`` / ``wide_n_max`` — the fused
        four-step switches to the n2 = 128 split when b >= wide_batch_min
        and wide_n_min <= n <= wide_n_max.
      * ``folded_n_max`` / ``folded_batch_min`` — the folded (zero-transpose)
        layout is used when n <= folded_n_max or b >= folded_batch_min.
      * ``stage_a_n1`` — the staged large-N column digit.
      * ``oa_block_min`` — smallest overlap-add block transform length.
      * ``rfft_pack_min`` — smallest n where a real-input forward transform
        runs as one n/2 complex transform plus an O(n) recombination.
      * ``half_spectrum_min`` — smallest n where a real-input transform
        computes only the k1 <= n1/2 half of the spectrum and mirrors the
        rest via Hermitian symmetry.
      * ``irfft_half_min`` — smallest n where a real-OUTPUT inverse folds
        the conjugate half of the input spectrum before the matmuls.
      * ``irfft_half_staged_min`` — smallest STAGED n where the real-output
        inverse runs stage A on only the first half of the column tiles
        (the rest are conjugate mirrors) + the per-row stage-B fold.
      * ``axis0_h_min`` / ``axis0_h_max`` / ``axis0_w_min`` — the 2-D column
        pass as axis-0 folded einsums (kernels/fused_jnp.py:transform_axis0).
      * ``irfft_direct_k128`` — the direct real-output inverse splits its
        h = n/2 + 1 contraction into K = n/2 dots + the rank-1 Nyquist term.
    """

    name: str
    wide_batch_min: int
    wide_n_min: int
    wide_n_max: int
    folded_n_max: int
    folded_batch_min: int
    stage_a_n1: int
    oa_block_min: int
    rfft_pack_min: int
    half_spectrum_min: int
    irfft_half_min: int
    irfft_half_staged_min: int
    axis0_h_min: int
    axis0_h_max: int
    axis0_w_min: int
    irfft_direct_k128: bool
    calibrated: bool  # True = every value measured on this device
    note: str


_H100 = ChipTuning(
    name="h100",
    wide_batch_min=16,
    wide_n_min=256,
    wide_n_max=16384,
    folded_n_max=16384,
    folded_batch_min=2,
    stage_a_n1=128,
    oa_block_min=16384,
    # Closed: the real-input packing path stays implemented and tested.
    rfft_pack_min=1 << 62,
    half_spectrum_min=1 << 15,
    irfft_half_min=1 << 15,
    irfft_half_staged_min=1 << 18,
    # Closed: transform_axis0 stays implemented and tested.
    axis0_h_min=1 << 62,
    axis0_h_max=1 << 62,
    axis0_w_min=512,
    irfft_direct_k128=True,
    calibrated=False,
    note=(
        "values carried over from an earlier accelerator, not measured on "
        "the H100; ROADMAP queue 1.5 lists each field"
    ),
)

TUNING = {
    "h100": _H100,
    # The CPU test mesh mirrors the h100 row so CPU tests exercise the
    # dispatch decisions the GPU takes.
    "cpu": replace(_H100, name="cpu", note="CPU test mesh: mirrors the h100 row"),
}


@functools.lru_cache(maxsize=1)
def _detected_tuning() -> ChipTuning:
    from .utils.roofline import device_key

    return TUNING[device_key()]


def get_tuning() -> ChipTuning:
    """The tuning row for the detected device (env-overridable).

    ``GPU_FFT_TPU_CHIP`` forces a row (useful for what-if runs and for
    tests asserting the table is consulted).
    """
    forced = os.environ.get("GPU_FFT_TPU_CHIP")
    if forced:
        key = forced.strip().lower()
        if key not in TUNING:
            raise ValueError(
                f"GPU_FFT_TPU_CHIP={forced!r} unknown; have {sorted(TUNING)}"
            )
        return TUNING[key]
    return _detected_tuning()
