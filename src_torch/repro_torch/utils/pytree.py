"""Pytree helpers used across the FL stack and the training substrate
(port of ``repro/utils/pytree.py``).

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors (or numpy arrays); ``None`` is an empty subtree.  Dict keys are
walked in sorted order and NamedTuple fields by name, as
``jax.tree_util`` walks them, so :func:`tree_flatten_with_paths` gives the
reference's ``keystr`` paths (``.params['embed']``,
``.opt_state.mu['scan_0']['mix']['wq']``, ``.step``) in the reference's
leaf order -- the checkpoint keys of both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn: Callable, tree, *rest, path: str = ""):
    """``fn(path, leaf, *other_leaves)`` over every leaf; ``rest`` are trees
    of the same structure as ``tree``.  Dicts come back with sorted keys,
    as ``jax.tree.map`` returns them."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=f"{path}[{k!r}]")
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=f"{path}.{name}")
            for i, (name, v) in enumerate(zip(tree._fields, tree))))
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=f"{path}[{i}]")
            for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *other_leaves)`` over every leaf (``jax.tree.map``)."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure with ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _itemsize(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.element_size()
    return np.dtype(x.dtype).itemsize


def tree_count(tree) -> int:
    """Total number of parameters."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * _itemsize(x) for x in tree_leaves(tree))


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, each leaf summed in fp32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def tree_to_numpy(tree):
    """Host numpy arrays; bf16 leaves come back as fp32 (numpy has no
    bf16)."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)
    return tree_map(conv, tree)


def tree_from_numpy(tree, like=None, device: DeviceLike = None):
    """Tensors from numpy arrays: with ``like``, each leaf takes the dtype
    and device of its ``like`` leaf; without, the array's dtype on
    ``device`` (None: the card)."""
    if like is None:
        dev = resolve_device(device)
        return tree_map(lambda x: torch.as_tensor(np.asarray(x), device=dev),
                        tree)
    return tree_map(lambda x, ref: torch.as_tensor(
        np.asarray(x), device=ref.device).to(ref.dtype), tree, like)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_weighted_mean(trees: List[Any], weights: List[float]):
    """Weighted average of a list of pytrees -- the heart of FedAvg."""
    total = float(sum(weights))
    if total <= 0:
        raise ValueError("weights must sum to a positive value")
    ws = [w / total for w in weights]
    out = tree_scale(trees[0], ws[0])
    for t, w in zip(trees[1:], ws[1:]):
        out = tree_add(out, tree_scale(t, w))
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    return all(np.allclose(_host(x), _host(y), rtol=rtol, atol=atol)
               for x, y in zip(la, lb))
