"""Multi-chip scaling over a JAX device mesh.

The reference is strictly single-device (SURVEY §2.4: no DP/TP/PP/SP, no
collectives — its only parallelism is intra-kernel threads and packed-batch
processing).  These modules are the scale-out extensions the
survey plans anyway:

* ``mesh.py``        — batch ("data-parallel") sharding: embarrassingly
                       parallel, zero comms, mirroring the reference's packed
                       batch buffer (``src/fft.rs:191-205``) across chips.
* ``distributed.py`` — one transform larger than a single chip: the
                       four-step factorization with the inter-stage
                       transpose as an all-to-all ("sequence-parallel"
                       axis).
"""

from .mesh import (
    default_mesh,
    fft2_batch_sharded,
    fft_batch_sharded,
    ifft_batch_sharded,
    lfilter_sharded,
    oaconvolve_sharded,
    welch_sharded,
)
from .distributed import distributed_fft, distributed_ifft
from .pencil import fft2_sharded, fftn_sharded, ifft2_sharded, ifftn_sharded

__all__ = [
    "default_mesh",
    "fft_batch_sharded",
    "fft2_batch_sharded",
    "ifft_batch_sharded",
    "lfilter_sharded",
    "oaconvolve_sharded",
    "welch_sharded",
    "distributed_fft",
    "distributed_ifft",
    "fft2_sharded",
    "ifft2_sharded",
    "fftn_sharded",
    "ifftn_sharded",
]
