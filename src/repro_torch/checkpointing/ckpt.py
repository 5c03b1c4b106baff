"""Fault-tolerant checkpointing of a tree of tensors (the LM trainer's
``{"params": ..., "opt": AdamWState}``), as ``repro.checkpointing.ckpt``.

Layout (one directory per step), the reference's:

    <root>/step_00000120.tmp/      # written first
        shard_00000.npz            # each host's leaves and blocks
        manifest.json              # keys, shapes, dtypes
    <root>/step_00000120/          # atomic rename = commit

* **atomic commit** — a crash mid-write never corrupts the latest
  checkpoint (readers only see renamed directories);
* **per-host shards** — each host (``host_id`` of ``n_hosts``) writes only
  the blocks of the :class:`~repro_torch.models.common.ShardedTree` s it
  owns, each block once (by the first rank of every axis it is replicated
  on), as ``shard_{host_id:05d}.npz``; host 0 writes the manifest and
  commits once every host's file is there;
* **resume / elastic re-mesh** — ``latest_step`` + ``restore_checkpoint``
  read the full logical arrays and rebuild the tree on the devices of a
  like tree, resharding onto any mesh: a like tree's ``ShardedTree`` onto
  its own mesh, or whole subtrees onto ``mesh`` by ``shardings``;
* **async save** — ``CheckpointManager`` copies the tree to the host, then
  serializes on a background thread; the train loop blocks only on the
  previous save;
* **keep-K GC**.

Leaves are keyed by their path joined with ``/`` (dict keys sorted, a
NamedTuple's field names, sequence indices; ``None`` holds no leaf); a
block's payload is named by its leaf and its slices.  numpy has no
bfloat16 without ``ml_dtypes``, so a bfloat16 leaf is stored as its 16-bit
pattern (int16) with ``"bfloat16"`` in the manifest and restored bit for
bit.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.common import (ShardedTree, block_slices, shard_params, spec_axes,
                             tree_items, tree_unflatten)

_SEP = "/"
COMMIT_TIMEOUT_S = 600


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs of a tree of dicts, NamedTuples, lists and tuples;
    a :class:`ShardedTree` is one leaf."""
    if tree is None:
        return
    if isinstance(tree, ShardedTree):
        yield _SEP.join(prefix), tree
    elif isinstance(tree, dict):
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
    if isinstance(like, ShardedTree):
        return next(values)
    if isinstance(like, dict):
        return {k: _rebuild(like[k], values) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, n), values) for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values) for v in like)
    return next(values)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _payload(t: torch.Tensor) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _block_name(name: str, slices) -> str:
    return name + "@" + ".".join(f"{s.start}-{s.stop}" for s in slices)


def _sharded_entries(key: str, sp: ShardedTree):
    """(manifest entry, {payload name: block}) of the blocks this process
    owns: a local rank writes a block when it is the first to hold it on
    every axis the block is replicated on."""
    mesh, entries, arrays = sp.mesh, [], {}
    for (path, l), (_, spec) in zip(tree_items(sp.template), tree_items(sp.specs)):
        k = _SEP.join((key,) + path) if key else _SEP.join(path)
        held = {a for e in spec for a in spec_axes(e)}
        for j, (b, r) in enumerate(zip(sp.blocks, mesh.local_ranks)):
            node = b
            for part in path:
                node = node[part]
            if j == 0:
                entries.append({"key": k, "shape": list(l.shape), "dtype": _dtype_name(node)})
            if all(mesh.axis_index(r, a) == 0 for a in ("data", "model") if a not in held):
                arrays[_block_name(k.replace("/", "__"),
                                   block_slices(spec, l.shape, mesh, r))] = _payload(node)
    return entries, arrays


def save_checkpoint(root: str, step: int, tree, *, host_id: int = 0, n_hosts: int = 1,
                    keep: int = 3) -> pathlib.Path:
    """Write this host's part of ``tree`` as step ``step`` under ``root``:
    whole leaves, and the blocks of its :class:`ShardedTree` s it owns, as
    ``shard_{host_id:05d}.npz``.  Host 0 writes the manifest, waits for the
    ``n_hosts`` shard files, commits by an atomic rename and keeps the
    newest ``keep`` steps."""
    rootp = pathlib.Path(root)
    tmp = rootp / f"step_{step:08d}.tmp"
    final = rootp / f"step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)

    arrays = {}
    manifest: Dict[str, Any] = {"step": step, "leaves": []}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, ShardedTree):
            entries, blocks = _sharded_entries(key, leaf)
            manifest["leaves"] += entries
            arrays.update(blocks)
            continue
        t = torch.as_tensor(leaf).detach().cpu()
        arrays[key.replace("/", "__")] = _payload(t)
        manifest["leaves"].append({"key": key, "shape": list(t.shape),
                                   "dtype": _dtype_name(t)})
    part = tmp / f"shard_{host_id:05d}.npz.part"
    with open(part, "wb") as f:
        np.savez(f, **arrays)
    os.replace(part, tmp / f"shard_{host_id:05d}.npz")   # a host's file appears whole
    if host_id != 0:
        return final
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    deadline = time.monotonic() + COMMIT_TIMEOUT_S
    while len(list(tmp.glob("shard_*.npz"))) < n_hosts:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{tmp}: {n_hosts} hosts' shards did not arrive")
        time.sleep(0.05)
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


def _read(final: pathlib.Path):
    """Every leaf of a committed step as a whole numpy array (its blocks
    assembled) and its manifest dtype, by key."""
    data: Dict[str, np.ndarray] = {}
    for f in sorted(final.glob("shard_*.npz")):
        with np.load(f) as z:
            data.update({k: z[k] for k in z.files})
    leaves = json.loads((final / "manifest.json").read_text())["leaves"]
    blocks: Dict[str, List[Tuple[str, np.ndarray]]] = {}
    for name, arr in data.items():
        if "@" in name:
            base, where = name.split("@")
            blocks.setdefault(base, []).append((where, arr))
    out = {}
    for l in leaves:
        name = l["key"].replace("/", "__")
        if name in data:
            arr = data[name]
        else:
            parts = blocks[name]
            arr = np.empty(l["shape"], dtype=parts[0][1].dtype)
            for where, blk in parts:
                sl = tuple(slice(*map(int, d.split("-"))) for d in where.split(".") if d)
                arr[sl] = blk
        if l["dtype"] == "bfloat16" and arr.dtype.kind == "V":
            # the reference's np.savez stores a bf16 leaf as the void dtype
            # |V2, which torch.from_numpy refuses; the bits are the same
            arr = arr.view(np.int16)
        t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
        out[l["key"]] = t.view(torch.bfloat16) if l["dtype"] == "bfloat16" else t
    return out


def restore_checkpoint(root: str, step: int, like_tree, *, mesh=None, shardings=None):
    """Rebuild ``like_tree``-structured tensors from step ``step``, each leaf
    in its saved dtype, from the full logical arrays: a tensor leaf on the
    like leaf's device (the CPU for a leaf that is not a tensor), a
    :class:`ShardedTree` resharded onto its own mesh and template, and,
    at each dict below the root where ``shardings`` (``like_tree``'s
    structure, as ``{"params": template, ...}``) holds a template tree, the
    whole subtree sharded onto ``mesh`` by it as one :class:`ShardedTree`:
    any mesh works (elastic re-mesh)."""
    full = _read(pathlib.Path(root) / f"step_{step:08d}")

    def build(like, shard, prefix):
        if like is None:
            return None
        if isinstance(like, ShardedTree) or (prefix and isinstance(like, dict)
                                             and isinstance(shard, dict)):
            tmpl = like.template if isinstance(like, ShardedTree) else shard
            target = like.mesh if isinstance(like, ShardedTree) else mesh
            dev = target.rank_device(target.local_ranks[0])
            whole = tree_unflatten(tmpl, [full[_SEP.join(prefix + path)].to(dev)
                                          for path, _ in tree_items(tmpl)])
            return shard_params(whole, tmpl, target)
        if isinstance(like, dict):
            return {k: build(like[k], None if shard is None else shard[k], prefix + (str(k),))
                    for k in sorted(like)}
        if isinstance(like, tuple) and hasattr(like, "_fields"):
            return type(like)(*(build(getattr(like, n),
                                      None if shard is None else getattr(shard, n),
                                      prefix + (n,)) for n in like._fields))
        if isinstance(like, (list, tuple)):
            return type(like)(build(v, None if shard is None else shard[i], prefix + (str(i),))
                              for i, v in enumerate(like))
        dev = like.device if isinstance(like, torch.Tensor) else torch.device("cpu")
        return full[_SEP.join(prefix)].to(dev)

    return build(like_tree, shardings, ())


def _gc(rootp: pathlib.Path, keep: int):
    steps = sorted(int(m.group(1)) for p in rootp.iterdir()
                   if (m := re.fullmatch(r"step_(\d+)", p.name)))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(rootp / f"step_{s:08d}", ignore_errors=True)


def _to_host(tree):
    """A copy of ``tree`` with every tensor copied to the CPU (a snapshot:
    training goes on updating the originals in place)."""
    def copy(l):
        if isinstance(l, ShardedTree):
            return ShardedTree(l.mesh, l.template, l.specs, [
                tree_unflatten(b, [t.detach().to("cpu", copy=True) for _, t in tree_items(b)])
                for b in l.blocks])
        return torch.as_tensor(l).detach().to("cpu", copy=True)

    return _rebuild(tree, iter([copy(l) for _, l in _leaves(tree)]))


class CheckpointManager:
    """Async double-buffered checkpointing with resume."""

    def __init__(self, root: str, keep: int = 3, every: int = 100, *, host_id: int = 0,
                 n_hosts: int = 1):
        self.root = root
        self.keep = keep
        self.every = every
        self.host_id, self.n_hosts = host_id, n_hosts
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree, *, force: bool = False):
        if not force and (self.every <= 0 or step % self.every != 0):
            return
        self.wait()  # block on the previous save only
        host_tree = _to_host(tree)  # snapshot before training continues
        self._thread = threading.Thread(
            target=save_checkpoint, args=(self.root, step, host_tree),
            kwargs={"keep": self.keep, "host_id": self.host_id, "n_hosts": self.n_hosts},
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like_tree, *, mesh=None, shardings=None):
        s = latest_step(self.root)
        if s is None:
            return None, None
        return s, restore_checkpoint(self.root, s, like_tree, mesh=mesh, shardings=shardings)
