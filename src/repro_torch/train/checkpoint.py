"""Atomic checkpoints of a training state (port of
``train/checkpoint.py``), in the reference's layout::

    <dir>/step_000000123/
        MANIFEST.json        {step, leaves: {path: file, shape, dtype}, extra}
        <leaf__path>.npy     one file per leaf
    <dir>/LATEST             text file: "step_000000123"

A state is a tree of nested dicts, tuples and named tuples (``OptState``)
with tensor leaves.  Writes are atomic: the leaves and the manifest go
to a ``.tmp-`` directory, are fsync'd, and the directory is renamed into
place; the ``LATEST`` pointer is written the same way.  A worker killed
mid-save never corrupts the restore point.

numpy has no bfloat16 without ``ml_dtypes``, so a bf16 leaf is stored as
its uint16 bits with ``"dtype": "bfloat16"`` in the manifest; ``restore``
gives every leaf back bit for bit, on the device of the matching leaf of
``like``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_BF16 = "bfloat16"


def _children(node):
    """[(name, child)] of an inner node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _rebuild(node, children):
    if isinstance(node, dict):
        return dict(zip(node.keys(), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def _map_with_path(fn, tree, path=()):
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    return _rebuild(tree, [_map_with_path(fn, v, path + (k,))
                           for k, v in kids])


def _leaf_name(path) -> str:
    return re.sub(r"[^A-Za-z0-9_./-]", "_", "/".join(path)) or "leaf"


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == _BF16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _fsync_write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, state: Any,
         extra: Optional[Dict] = None) -> str:
    """Write ``state`` as step ``step`` and point ``LATEST`` at it;
    returns the step directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(prefix=".tmp-", dir=ckpt_dir)
    leaves = {}

    def write(path, leaf):
        name = _leaf_name(path)
        arr, dtype = _to_numpy(leaf)
        fn = os.path.join(tmp, name.replace("/", "__") + ".npy")
        with open(fn, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        leaves[name] = {"file": os.path.basename(fn),
                        "shape": list(arr.shape), "dtype": dtype}

    _map_with_path(write, state)
    _fsync_write(os.path.join(tmp, "MANIFEST.json"), json.dumps(
        {"step": step, "leaves": leaves, "extra": extra or {}}, indent=1))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    ptr = os.path.join(ckpt_dir, "LATEST")
    _fsync_write(ptr + ".tmp", os.path.basename(final))
    os.rename(ptr + ".tmp", ptr)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[-1])


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None
            ) -> Tuple[Any, int, Dict]:
    """(state in the structure of ``like``, its step, the ``extra`` dict
    saved with it).  Each leaf comes back bit for bit on the device of
    the matching leaf of ``like``; a shape differing from it raises
    ``ValueError``.  ``step`` defaults to ``LATEST``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)

    def read(path, leaf_like):
        name = _leaf_name(path)
        meta = manifest["leaves"][name]
        arr = np.load(os.path.join(d, meta["file"]))
        if tuple(arr.shape) != tuple(leaf_like.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(leaf_like.shape)}")
        return _from_numpy(arr, meta["dtype"], leaf_like.device)

    state = _map_with_path(read, like)
    return state, step, manifest.get("extra", {})


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` step directories."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(n.split("_")[-1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)
