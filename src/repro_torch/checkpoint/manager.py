"""Fault-tolerant checkpointing: atomic, checksummed (port of
``repro.checkpoint.manager``, on its on-disk format).

  * **Atomic**: write into `step_<k>.tmp/`, fsync the manifest, then
    rename -- a crash mid-write never corrupts the latest valid
    checkpoint.
  * **Checksummed**: every leaf gets a CRC32 of its bytes recorded in
    manifest.json; restore verifies before handing tensors to the trainer.
  * **Keep-N**: bounded disk use; the newest `keep` checkpoints survive.
  * **Auto-resume**: `latest_step()` scans for the newest *valid* manifest
    (a torn checkpoint is skipped, the previous one restores).

The format is the JAX package's, so a checkpoint crosses between the two
packages: a leaf is named by its path (dict keys walked sorted, list and
tuple indices; None is no leaf), one ``.npy`` file a leaf named by the
path with ``/`` -> ``__``, and the manifest keeps its shape, dtype name
and CRC32.  A bfloat16 leaf is written as the JAX package writes one
(``np.save`` of an ``ml_dtypes`` bfloat16 array: header ``'<V2'``, the
raw two-byte values) and read back through an int16 view, so neither
side needs ``ml_dtypes``.

On a mesh (the multi-rank trainer) every rank calls ``save_tree`` with
its ``DTensor`` leaves: each leaf is gathered (``full_tensor()``, a
collective) and rank 0 writes the same full logical arrays as a
one-device run, while the other ranks wait at a barrier.  ``restore_tree``
(and ``CheckpointManager.resume``) with ``shardings=`` distributes each
restored leaf onto the current mesh -- the elastic reshard-on-load path:
a checkpoint of any mesh (or of one device, or of the JAX package)
restores onto any other.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tune import resolve_device
from repro_torch.dist.sharding import (_is_dtensor, _leaves_with_paths,
                                       distribute_leaf)
from repro_torch.tree import is_bfloat16, leaf_from_numpy

_BF16_DESCR = "<V2"


def _crc32(arr: np.ndarray) -> int:
    """CRC32 of a contiguous array's bytes (read in place, no copy)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(flat) & 0xFFFFFFFF


def _flatten_with_paths(tree, prefix=()):
    """[(key, leaf)] in the JAX package's flattening order and naming."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten_with_paths(x, prefix + (i,))]
    return [("/".join(str(p) for p in prefix), tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flattening
    order, from the iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)([_unflatten(x, leaves) for x in like])
    return next(leaves)


def _as_numpy(leaf) -> tuple:
    """(array whose bytes are stored, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if is_bfloat16(arr):
        return arr.view(np.int16), "bfloat16"
    return arr, str(arr.dtype)


def _save_npy(path: str, arr: np.ndarray, dtype_name: str):
    if dtype_name != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        np.ascontiguousarray(arr).tofile(f)


def _group_rank():
    """(rank, world size) of the default process group; (0, 1) where
    there is none."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_tree(directory: str, step: int, tree: Any, *,
              meta: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically save a tree checkpoint.  Returns the final path.

    ``DTensor`` leaves are gathered one at a time (every rank must call
    this); rank 0 writes each and the others wait for it at a barrier."""
    rank, world = _group_rank()
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if rank == 0:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    for key, leaf in _flatten_with_paths(tree):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        if rank != 0:
            continue
        arr, dtype_name = _as_numpy(leaf)
        fn = key.replace("/", "__") + ".npy"
        _save_npy(os.path.join(tmp, fn), arr, dtype_name)
        manifest["leaves"][key] = {
            "file": fn,
            "shape": list(arr.shape),
            "dtype": dtype_name,
            "crc32": _crc32(arr),
        }
    if rank == 0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

        # keep-N garbage collection
        steps = sorted(all_steps(directory))
        for s in steps[:-keep] if keep > 0 else []:
            shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                          ignore_errors=True)
    if world > 1:
        import torch.distributed as dist
        dist.barrier()
    return final


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    while steps:
        s = steps[-1]
        try:
            with open(os.path.join(directory, f"step_{s:08d}",
                                   "manifest.json")) as f:
                json.load(f)
            return s
        except (OSError, ValueError):
            steps.pop()   # torn manifest: fall back to previous
    return None


def restore_tree(directory: str, step: int, like: Any, *,
                 shardings: Any = None, verify: bool = True) -> Any:
    """Restore a tree saved by save_tree (by either package).

    `like` supplies the tree structure (values ignored).  Each leaf comes
    back as a tensor of its saved dtype on the device of `like`'s leaf
    where that is a tensor (a ``DTensor``'s local device), else on the
    card.  If `shardings` (a matching tree of
    ``dist.sharding.Sharding``) is given, every rank reads the full
    arrays and each leaf is distributed with its sharding -- the elastic
    reshard-on-load path.  Returns (tree, meta).
    """
    base = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = ({} if shardings is None else
              {"/".join(str(p) for p in path): sh
               for path, sh in _leaves_with_paths(shardings)})

    leaves = []
    for key, like_leaf in _flatten_with_paths(like):
        entry = manifest["leaves"][key]
        arr = np.load(os.path.join(base, entry["file"]))
        if verify:
            crc = _crc32(arr)
            if crc != entry["crc32"]:
                raise IOError(f"checksum mismatch for {key} in {base}")
        if _is_dtensor(like_leaf):
            where = like_leaf.to_local().device
        elif isinstance(like_leaf, torch.Tensor):
            where = like_leaf.device
        else:
            where = resolve_device(None)
        leaf = leaf_from_numpy(arr, where)
        if shardings is not None:   # one whole leaf on the device at a time
            leaf = distribute_leaf(leaf, by_key[key])
        leaves.append(leaf)
    return _unflatten(like, iter(leaves)), manifest["meta"]


class CheckpointManager:
    """Step-driven wrapper: save every `period`, auto-resume from latest."""

    def __init__(self, directory: str, *, period: int = 100, keep: int = 3):
        self.directory = directory
        self.period = period
        self.keep = keep

    def maybe_save(self, step: int, tree: Any, meta: Optional[dict] = None):
        if step % self.period == 0:
            return save_tree(self.directory, step, tree, meta=meta,
                             keep=self.keep)
        return None

    def resume(self, like: Any, shardings: Any = None):
        """Returns (tree, meta, step) or (None, None, 0) if fresh; with
        ``shardings``, the tree distributed onto their mesh."""
        step = latest_step(self.directory)
        if step is None:
            return None, None, 0
        tree, meta = restore_tree(self.directory, step, like,
                                  shardings=shardings)
        return tree, meta, step
