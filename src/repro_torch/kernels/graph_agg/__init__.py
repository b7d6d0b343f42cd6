"""GIN's neighbour sum in a fixed order (a port-only kernel: the JAX
package aggregates with ``jax.ops.segment_sum``, which has no Pallas
kernel): the CSR build, the wrapper that launches the CUDA kernel, its
plain PyTorch version and the ``autograd.Function``."""
from .ops import (CSROrder, GraphCSR, build_csr, csr_gather_sum,
                  csr_gather_sum_plain, gin_aggregate)
from .ref import gather_sum_ref

__all__ = ["CSROrder", "GraphCSR", "build_csr", "csr_gather_sum",
           "csr_gather_sum_plain", "gin_aggregate", "gather_sum_ref"]
