"""Compute kernels: DFT/twiddle table generation, the fused-size four-step
einsum graphs, and the large-N staged factorization — all plain JAX."""
