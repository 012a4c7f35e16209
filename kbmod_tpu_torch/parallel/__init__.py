"""Multi-device and multi-process execution of the search: the sharded
psi/phi build and top-K search over a mesh of devices
(:mod:`kbmod_tpu_torch.parallel.sharded`) and the ``torch.distributed``
process group (:mod:`kbmod_tpu_torch.parallel.distributed`). Port of the
JAX package's parallel/."""

from kbmod_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_distributed,
    assign_patches_to_hosts,
)
from kbmod_tpu_torch.parallel.sharded import (
    build_mesh,
    sharded_search_topk,
    sharded_core_search,
    sharded_psi_phi_build,
    sharded_sigmag_exact_topk,
)

__all__ = [
    "initialize_distributed",
    "is_distributed",
    "assign_patches_to_hosts",
    "build_mesh",
    "sharded_search_topk",
    "sharded_core_search",
    "sharded_psi_phi_build",
    "sharded_sigmag_exact_topk",
]
