"""Numpy checkpointing (port of ``repro/checkpoint/checkpoint.py``).

A checkpoint is an ``.npz`` per save, keyed by each leaf's
``jax.tree_util.keystr`` path (:func:`repro_torch.utils.pytree.tree_flatten_with_paths`),
plus a JSON manifest -- the reference's file names, keys and manifest, so
a checkpoint saved by either package restores in the other.  bf16 leaves
are stored upcast to fp32; a restore casts each leaf to the dtype and
device of its ``like_tree`` leaf.  Writes are atomic (tmp + rename): a
resumed run finds only complete steps.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map_with_path

#: dtypes numpy stores as they are; any other (bf16, fp8) is upcast to fp32
_NUMPY_DTYPES = (torch.float16, torch.float32, torch.float64, torch.int8,
                 torch.int16, torch.int32, torch.int64, torch.uint8,
                 torch.bool)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype not in _NUMPY_DTYPES:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in tree_flatten_with_paths(tree)}


def _atomic_write(final: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(final),
                               suffix=".tmp" + os.path.splitext(final)[1])
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    extra: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    manifest = {
        "step": int(step),
        "keys": sorted(flat.keys()),
        "extra": extra or {},
    }
    final = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    _atomic_write(final, lambda tmp: np.savez(tmp, **flat))

    def write_manifest(tmp):
        with open(tmp, "w") as f:
            json.dump(manifest, f)

    _atomic_write(os.path.join(ckpt_dir, f"ckpt_{step:08d}.json"),
                  write_manifest)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(fn[5:13]) for fn in os.listdir(ckpt_dir)
             if fn.startswith("ckpt_") and fn.endswith(".npz")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like_tree, step: Optional[int] = None):
    """Restore into the structure of ``like_tree`` (dtypes and devices
    taken from it).  Returns ``(tree, step)``."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    with np.load(os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")) as data:
        def load(key, ref):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"shape mismatch for {key}: {arr.shape} vs {ref.shape}")
            return torch.from_numpy(arr).to(device=ref.device,
                                            dtype=ref.dtype)

        return tree_map_with_path(load, like_tree), step
