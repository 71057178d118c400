"""Checkpointing with atomic commits and background writes.

Port of ``repro/ckpt/manager.py`` (DESIGN.md §6), in its on-disk layout:

  * ``save(step, tree)`` writes one ``leaf_%05d.npy`` per leaf and a
    ``meta.json`` (``n_leaves``, ``treedef``, ``dtypes``) into a temporary
    step directory, committed by atomic rename, so a crash mid-save never
    corrupts the latest good checkpoint; bfloat16 leaves are stored as their
    uint16 bit patterns with the true dtype in ``dtypes``;
  * the write can run on a background thread (``blocking=False``) off a
    host snapshot taken at once;
  * ``keep=N`` garbage-collects old steps; ``latest_step()`` scans for
    resume;
  * ``restore(step, like)`` rebuilds ``like``'s structure, each tensor leaf
    in its dtype on its device.

Leaves go in JAX's flatten order (:func:`tree_leaves`: dict keys sorted,
NamedTuple fields and sequences in order, None holds no leaf), so a
checkpoint the reference writes restores into the port's trees and back.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, NamedTuples, lists and tuples, in
    JAX's flatten order (dict keys sorted; None holds no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_structure(tree):
    """A comparable description of a tree's nodes (not its leaves)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(tree_structure(v) for v in tree))
    return "*"


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves, in :func:`tree_leaves` order,
    replaced by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            if hasattr(node, "_fields"):
                return type(node)(*vals)
            return type(node)(vals)
        return next(it)
    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the structure holds")
    return out


def _host_leaf(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy snapshot in its stored form, and its dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _restored_leaf(arr: np.ndarray, dtype: str | None, like):
    """A stored array back as ``like``'s kind: a tensor of its dtype on its
    device, or a numpy array (of its dtype where it has one)."""
    if isinstance(like, torch.Tensor):
        if dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(like.device, like.dtype)
    if hasattr(like, "dtype") and arr.dtype != like.dtype:
        arr = arr.astype(like.dtype)
    return arr


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int, tmp=False) -> str:
        return os.path.join(self.dir, ("tmp_" if tmp else "") + f"step_{step:010d}")

    def latest_step(self) -> int | None:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                 if d.startswith("step_")]
        return max(steps) if steps else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Snapshot ``tree`` to host memory now, write it (on a background
        thread unless ``blocking``) and commit it by atomic rename."""
        pairs = [_host_leaf(leaf) for leaf in tree_leaves(tree)]
        host = [arr for arr, _ in pairs]
        meta = {"n_leaves": len(host), "treedef": str(tree_structure(tree)),
                "dtypes": [dtype for _, dtype in pairs]}

        def write():
            tmp = self._step_dir(step, tmp=True)
            os.makedirs(tmp, exist_ok=True)
            for i, arr in enumerate(host):
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)             # atomic commit
            self._gc()

        if blocking:
            write()
        else:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like``: each tensor leaf in its
        dtype on its device."""
        d = self._step_dir(step)
        leaves_like = tree_leaves(like)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if meta["n_leaves"] != len(leaves_like):
            raise ValueError(f"checkpoint holds {meta['n_leaves']} leaves, the "
                             f"structure {len(leaves_like)}")
        dtypes = meta.get("dtypes", [None] * len(leaves_like))
        return tree_unflatten(like, [
            _restored_leaf(np.load(os.path.join(d, f"leaf_{i:05d}.npy")),
                           dtypes[i], leaf)
            for i, leaf in enumerate(leaves_like)])
