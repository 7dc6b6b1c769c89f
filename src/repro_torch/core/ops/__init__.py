"""The port's op registry and its families (twin of ``repro.core.ops``).

Importing this package registers the ``gemm``, ``attention`` and
``grouped`` families with their ``torch`` reference impls and their
hand-written CUDA impls (``cuda``, ``cuda_fused``, ``cuda_grouped``).
"""

from repro_torch.core.ops import registry
from repro_torch.core.ops.registry import (
    LADDER_BOUNDS,
    Capabilities,
    KernelImpl,
    OpSpec,
    Partitioning,
    available_impls,
    families,
    get_family,
    get_impl,
    reference_impl,
    register_family,
    register_impl,
)
from repro_torch.core.ops.shard import MeshSpec
from repro_torch.core.ops.route import (
    ExecutionPolicy,
    Route,
    as_route,
    normalize_backends,
    parse_backend_flags,
    validate_backends,
)
from repro_torch.core.ops.tiles import (
    TileConfig,
    align_group_counts,
    pad2,
    round_up,
    set_default_tiles,
    set_tiles,
    tile_for,
)
from repro_torch.core.ops.gemm import gemm, routed_einsum, torch_policy_einsum  # noqa: I001
from repro_torch.core.ops.attention import (
    AttentionOps,
    attention_decode,
    attention_forward,
    attention_paged_decode,
)
from repro_torch.core.ops.grouped import grouped_matmul, grouped_tiles

__all__ = [
    "registry", "LADDER_BOUNDS", "Capabilities", "KernelImpl", "OpSpec", "Partitioning",
    "MeshSpec",
    "available_impls", "families", "get_family", "get_impl",
    "reference_impl", "register_family", "register_impl",
    "ExecutionPolicy", "Route", "as_route", "normalize_backends",
    "parse_backend_flags", "validate_backends",
    "TileConfig", "align_group_counts", "pad2", "round_up", "set_default_tiles",
    "set_tiles", "tile_for",
    "gemm", "routed_einsum", "torch_policy_einsum",
    "AttentionOps", "attention_decode", "attention_forward",
    "attention_paged_decode", "grouped_matmul", "grouped_tiles",
]
