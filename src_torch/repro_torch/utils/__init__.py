"""Helpers of the port: the pytree helpers (port of ``repro/utils``) and
the stdlib-only msgpack subset of the wire (``msgpack_lite``)."""
from repro_torch.utils.pytree import (  # noqa: F401
    tree_bytes,
    tree_count,
    tree_flatten_with_paths,
    tree_global_norm,
    tree_to_numpy,
    tree_from_numpy,
    tree_zeros_like,
    tree_add,
    tree_sub,
    tree_scale,
    tree_weighted_mean,
    tree_allclose,
)
