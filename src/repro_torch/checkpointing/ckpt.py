"""Fault-tolerant checkpointing of a tree of tensors (the LM trainer's
``{"params": ..., "opt": AdamWState}``), as ``repro.checkpointing.ckpt``.

Layout (one directory per step), the reference's:

    <root>/step_00000120.tmp/      # written first
        shard_00000.npz            # this host's leaves
        manifest.json              # keys, shapes, dtypes
    <root>/step_00000120/          # atomic rename = commit

* **atomic commit** — a crash mid-write never corrupts the latest
  checkpoint (readers only see renamed directories);
* **resume** — ``latest_step`` + ``restore_checkpoint`` rebuild the tree on
  the devices of a like tree;
* **async save** — ``CheckpointManager`` copies the tree to the host, then
  serializes on a background thread; the train loop blocks only on the
  previous save;
* **keep-K GC**.

Leaves are keyed by their path joined with ``/`` (dict keys sorted, a
NamedTuple's field names, sequence indices; ``None`` holds no leaf).
numpy has no bfloat16 without ``ml_dtypes``, so a bfloat16 leaf is stored
as its 16-bit pattern (int16) with ``"bfloat16"`` in the manifest and
restored bit for bit.  One device, one host: the reference's per-host
shards degenerate to one file (``shard_00000.npz``), and its ``mesh`` /
``shardings`` arguments wait for a multi-card slice.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs of a tree of dicts, NamedTuples, lists and tuples."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _rebuild(like, values: Iterator):
    """A tree of ``like``'s structure holding the next items of ``values``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], values) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, n), values) for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values) for v in like)
    return next(values)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def save_checkpoint(root: str, step: int, tree, *, keep: int = 3) -> pathlib.Path:
    """Write ``tree`` as step ``step`` under ``root`` (tmp dir, then an
    atomic rename) and keep the newest ``keep`` steps."""
    rootp = pathlib.Path(root)
    tmp = rootp / f"step_{step:08d}.tmp"
    final = rootp / f"step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)

    arrays = {}
    manifest: Dict[str, Any] = {"step": step, "leaves": []}
    for key, leaf in _leaves(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        arrays[key.replace("/", "__")] = arr
        manifest["leaves"].append({"key": key, "shape": list(t.shape),
                                   "dtype": _dtype_name(t)})
    np.savez(tmp / "shard_00000.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _gc(rootp, keep)
    return final


def latest_step(root: str) -> Optional[int]:
    rootp = pathlib.Path(root)
    if not rootp.exists():
        return None
    steps = [int(m.group(1)) for p in rootp.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


def restore_checkpoint(root: str, step: int, like_tree):
    """Rebuild ``like_tree``-structured tensors from step ``step``: each leaf
    in its saved dtype, on the device of the like tree's leaf (the CPU for
    a leaf that is not a tensor)."""
    final = pathlib.Path(root) / f"step_{step:08d}"
    data: Dict[str, np.ndarray] = {}
    for f in sorted(final.glob("shard_*.npz")):
        with np.load(f) as z:
            data.update({k: z[k] for k in z.files})
    dtypes = {l["key"]: l["dtype"]
              for l in json.loads((final / "manifest.json").read_text())["leaves"]}
    out: List[torch.Tensor] = []
    for key, leaf in _leaves(like_tree):
        arr = data[key.replace("/", "__")]
        if dtypes[key] == "bfloat16" and arr.dtype.kind == "V":
            # the reference's np.savez stores a bf16 leaf as the void dtype
            # |V2, which torch.from_numpy refuses; the bits are the same
            arr = arr.view(np.int16)
        t = torch.from_numpy(arr)
        if dtypes[key] == "bfloat16":
            t = t.view(torch.bfloat16)
        dev = leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cpu")
        out.append(t.to(dev))
    return _rebuild(like_tree, iter(out))


def _gc(rootp: pathlib.Path, keep: int):
    steps = sorted(int(m.group(1)) for p in rootp.iterdir()
                   if (m := re.fullmatch(r"step_(\d+)", p.name)))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(rootp / f"step_{s:08d}", ignore_errors=True)


def _to_host(tree):
    """A copy of ``tree`` with every tensor copied to the CPU (a snapshot:
    training goes on updating the originals in place)."""
    return _rebuild(tree, iter([torch.as_tensor(l).detach().to("cpu", copy=True)
                                for _, l in _leaves(tree)]))


class CheckpointManager:
    """Async double-buffered checkpointing with resume."""

    def __init__(self, root: str, keep: int = 3, every: int = 100):
        self.root = root
        self.keep = keep
        self.every = every
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree, *, force: bool = False):
        if not force and (self.every <= 0 or step % self.every != 0):
            return
        self.wait()  # block on the previous save only
        host_tree = _to_host(tree)  # snapshot before training continues
        self._thread = threading.Thread(
            target=save_checkpoint, args=(self.root, step, host_tree),
            kwargs={"keep": self.keep}, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like_tree):
        s = latest_step(self.root)
        if s is None:
            return None, None
        return s, restore_checkpoint(self.root, s, like_tree)
