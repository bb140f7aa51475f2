"""Checkpointing: atomic, async, auto-resuming, pure numpy npz (port of
``repro.checkpoint.manager``).

Layout:  <dir>/step_<n>/shard_<p>.npz + manifest.json
  * leaves flattened with the reference's '/'-joined key paths (dict keys,
    list/tuple indices, ``.name`` for NamedTuple fields), so a checkpoint
    written by either package restores in the other;
  * bf16 leaves are stored as their raw uint16 bits under the key tagged
    ``::bfloat16`` (npz has no bf16), as the reference does;
  * atomic via write-to-tmp + os.replace (a crashed save never corrupts the
    latest checkpoint);
  * async save on a background thread: tensors are copied to host numpy
    before the thread starts, so training may update them in place at once;
  * ``restore_latest`` picks the newest *complete* checkpoint (the manifest
    is written last), so partial saves from a killed job are skipped;
  * checkpoints do not depend on the mesh: a mesh's save (``specs`` and
    ``axes``: the tree holds this rank's shards) gathers each leaf whole,
    one at a time, into host memory, rank 0 writes the whole leaves and
    every rank waits for the write; a restore reads whole leaves, which
    each rank cuts into its shards (``parallel.sharding.shard_tree``), so
    a job saved on one mesh resumes on another (the reference's elastic
    re-mesh).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel import sharding
from repro_torch.tree import leaves


def _map_paths(fn, tree, prefix=()):
    """``tree`` with each leaf replaced by ``fn(key path, leaf)``; key paths
    are the reference's jax key paths joined by '/'."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_paths(fn, x, prefix + (f".{name}",))
                            for name, x in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, x, prefix + (str(i),))
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(prefix), tree)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(host array, key tag): bf16 becomes its uint16 bits, tagged."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf, copy=True), ""
    t = leaf.detach()
    # a device tensor's host copy is already private; a host tensor's view
    # must be copied, or later in-place updates would reach the snapshot
    t = t.clone() if t.device.type == "cpu" else t.to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "::bfloat16"
    return t.numpy(), ""


def _flatten(tree, whole=None) -> Dict[str, np.ndarray]:
    """Host numpy of every leaf by key; ``whole(key, leaf)``, when given,
    makes each leaf whole first (None: this rank keeps nothing)."""
    flat = {}

    def put(key, leaf):
        if whole is not None:
            leaf = whole(key, leaf)
            if leaf is None:
                return
        arr, tag = _to_numpy(leaf)
        flat[key + tag] = arr
    _map_paths(put, tree)
    return flat


def _gathered(specs, axes):
    """``whole`` for ``_flatten`` on a mesh: each leaf all-gathered over
    the axes of its spec (every rank joins), kept on rank 0 only."""
    by_key = {}
    _map_paths(by_key.__setitem__, specs)
    rank0 = all(i == 0 for i in axes.coords.values())

    def whole(key, leaf):
        t = leaf.detach()
        if axes.data.backend == "gloo":
            t = t.cpu()         # gloo stages a device tensor there anyway
        full = sharding.gather_shard(t, by_key[key], axes.axes)
        return full if rank0 else None
    return whole, rank0


def _mesh_barrier(axes, device):
    """Every rank of the mesh waits for rank 0: "model" first, so a rank
    off rank 0's "model" group waits through one that waited for it."""
    z = torch.zeros((1,), device=device)
    axes.model.all_reduce(z)
    axes.data.all_reduce(z)


def _write(flat: Dict[str, np.ndarray], directory: str, step: int,
           process_index: int = 0) -> str:
    d = os.path.join(directory, f"step_{step:09d}")
    tmp = d + f".tmp{process_index}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"shard_{process_index}.npz"), **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat.keys()),
        "nbytes": int(sum(v.nbytes for v in flat.values())),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.replace(tmp, d)                      # atomic publish
    return d


def save(tree, directory: str, step: int, process_index: int = 0) -> str:
    return _write(_flatten(tree), directory, step, process_index)


def _leaf_from(arr: np.ndarray, tag: str) -> torch.Tensor:
    """A tensor on ``arr``'s memory (``np.load`` reads each array into a
    fresh one, so nothing else holds it)."""
    if tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if tag:
        raise TypeError(f"unsupported stored dtype tag {tag!r}")
    return torch.from_numpy(arr)


def restore(tree_like, directory: str, step: int, process_index: int = 0):
    """The checkpoint at ``step`` as a tree shaped like ``tree_like``, with
    each leaf a CPU tensor in the dtype of its ``tree_like`` leaf."""
    d = os.path.join(directory, f"step_{step:09d}")
    with np.load(os.path.join(d, f"shard_{process_index}.npz")) as z:
        names = {key.partition("::")[0]: key for key in z.files}

        def take(key, like):            # reads only the leaves asked for
            name = names[key]
            leaf = _leaf_from(z[name], name.partition("::")[2])
            if tuple(leaf.shape) != tuple(like.shape):
                raise ValueError(f"{key}: stored {tuple(leaf.shape)}, "
                                 f"expected {tuple(like.shape)}")
            return leaf.to(like.dtype)
        return _map_paths(take, tree_like)


def completed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp0"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def latest_step(self) -> Optional[int]:
        steps = completed_steps(self.directory)
        return steps[-1] if steps else None

    def save(self, tree, step: int, blocking: bool = True, specs=None,
             axes=None):
        """Write ``tree`` as the checkpoint of ``step``.  On a mesh
        (``specs``: the tree's partition specs, ``axes``: this rank's
        ``comm.MeshAxes``) every rank calls it: the leaves are gathered
        whole one at a time, rank 0 writes them and every rank returns
        after the write (``blocking`` is then implied)."""
        self.wait()                 # one save at a time
        if specs is not None:
            whole, rank0 = _gathered(specs, axes)
            flat = _flatten(tree, whole)
            if rank0:
                _write(flat, self.directory, step)
                self._gc()
            _mesh_barrier(axes, leaves(tree)[0].device)
            return
        flat = _flatten(tree)       # snapshot to host numpy, on this thread

        def do():
            _write(flat, self.directory, step)
            self._gc()

        if blocking:
            do()
        else:
            self._thread = threading.Thread(target=do, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, tree_like):
        self.wait()
        step = self.latest_step()
        if step is None:
            return None, None
        return restore(tree_like, self.directory, step), step

    def _gc(self):
        steps = completed_steps(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)


@torch.no_grad()
def copy_into(dst, src):
    """Copy every leaf of ``src`` into the leaf of ``dst`` at the same key
    path, in place (a restored host tree into live device tensors)."""
    flat = {}
    _map_paths(flat.__setitem__, src)
    _map_paths(lambda key, d: d.copy_(flat[key]), dst)
    return dst
