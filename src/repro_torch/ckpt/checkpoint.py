"""Atomic checkpoints in the JAX package's on-disk format (port of
``repro/ckpt/checkpoint.py``): either package restores the other's.

Layout: <dir>/step_<N>/
    manifest.json        {"step": N, "leaves": {key: {"shape", "dtype"}}}
    shard_<host>.npz     each leaf's raw little-endian bytes as a uint8
                         array under its key
    COMMITTED            empty marker written last (atomic commit)

Keys join a tree's dict keys and tuple indices with ``/`` (an
``OptState`` is a tuple: ``opt/0`` is its step, ``opt/1/...`` its first
moment). Dtypes are written as numpy names them (``float32``, ``int32``,
``bfloat16``); a bfloat16 leaf is read back through an int16 view, so no
numpy bfloat16 type is needed. A directory is trusted only once it holds
``COMMITTED``; ``latest_step`` scans for the newest such step, and
``_gc`` keeps the last ``keep``. ``restore(shardings=)`` places each
leaf by its ``models.module.Sharding`` record, whatever the mesh at save
time (elastic restore): each rank keeps the block that JAX's
``NamedSharding`` gives its device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models.module import Sharding

SEP = "/"
_NAMES = {torch.float64: "float64", torch.float32: "float32",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _flatten(tree, leaf=lambda node: False) -> dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if leaf(node):
            flat[prefix] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{SEP}{k}" if prefix else str(k), v)
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(f"{prefix}{SEP}{i}" if prefix else str(i), v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _map(fn: Callable, node):
    """``fn`` over the leaves of a tree of dicts, lists, tuples and
    NamedTuples, keeping its structure."""
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        vals = [_map(fn, v) for v in node]
        return type(node)(*vals) if hasattr(node, "_fields") else type(node)(vals)
    return fn(node)


def _host_bytes(leaf) -> tuple[np.ndarray, str, list]:
    """A leaf (tensor or array) -> (its raw bytes as a flat uint8 array,
    numpy's name of its dtype, its shape)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _NAMES[t.dtype]
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
        name = str(arr.dtype)
    return arr.reshape(-1).view(np.uint8), name, list(arr.shape)


def _from_bytes(raw: np.ndarray, meta: dict) -> torch.Tensor:
    """Raw bytes and their manifest entry -> a CPU tensor."""
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.view(np.dtype(meta["dtype"])))
    return t.reshape(meta["shape"])


def save(ckpt_dir: str | Path, step: int, tree, *, host_id: int = 0,
         keep: int = 3) -> Path:
    """Synchronous save with atomic commit; returns the step's directory."""
    ckpt_dir = Path(ckpt_dir)
    out = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}_{host_id}"
    tmp.mkdir(parents=True, exist_ok=True)

    manifest = {"step": step, "leaves": {}}
    arrays = {}
    for key, leaf in _flatten(tree).items():
        arrays[key], dtype, shape = _host_bytes(leaf)
        manifest["leaves"][key] = {"shape": shape, "dtype": dtype}
    np.savez(tmp / f"shard_{host_id}.npz", **arrays)
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
    # atomic publish: rename tmp -> final, then COMMITTED marker
    if out.exists():
        shutil.rmtree(out)
    os.replace(tmp, out)
    (out / "COMMITTED").touch()
    _gc(ckpt_dir, keep)
    return out


class AsyncCheckpointer:
    """Overlap checkpoint writes with training: ``save`` returns after
    copying the tree to host memory; the disk write happens on a worker
    thread. ``wait()`` joins the outstanding write and raises what it
    raised (call before exit)."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree):
        snapshot = _map(
            lambda a: a.detach().to("cpu", copy=True)
            if isinstance(a, torch.Tensor) else np.array(a), tree)
        self.wait()
        self._thread = threading.Thread(target=self._write,
                                        args=(step, snapshot), daemon=True)
        self._thread.start()

    def _write(self, step: int, snapshot) -> None:
        try:
            save(self.ckpt_dir, step, snapshot, keep=self.keep)
        except Exception as e:  # re-raised by wait() in the caller
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / "COMMITTED").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def shard_of(t: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's block of the global ``t`` under ``sharding`` (a
    ``(mesh, spec)`` record): dimension i splits into the product of its
    spec entry's axis sizes, and the rank takes the block its coordinates
    on those axes name, the first axis major (JAX's ``NamedSharding``)."""
    mesh, spec = sharding
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        blocks, block = 1, 0
        for a in axes:
            blocks, block = blocks * mesh.shape[a], (
                block * mesh.shape[a] + mesh.coordinate(a))
        size = t.shape[dim] // blocks
        t = t.narrow(dim, block * size, size)
    return t.contiguous()


def restore(ckpt_dir: str | Path, tree_like, *, step: Optional[int] = None,
            shardings=None):
    """Restore into the structure of ``tree_like`` (tensors of the global
    shapes): each leaf takes its template's dtype and device. Returns
    (tree, step). ``shardings`` (a matching tree of ``Sharding`` records,
    ``models.module.make_shardings``) makes each leaf this rank's block
    (``shard_of``). Raises ``KeyError`` for a leaf the checkpoint lacks
    and ``ValueError`` for a shape that differs from the template's."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    src = ckpt_dir / f"step_{step:08d}"
    with open(src / "manifest.json") as f:
        manifest = json.load(f)
    shards = [np.load(shard) for shard in sorted(src.glob("shard_*.npz"))]
    try:
        where = {k: z for z in shards for k in z.files}
        flat_sh = ({} if shardings is None else
                   _flatten(shardings, lambda n: isinstance(n, Sharding)))
        out_flat = {}
        for key, like in _flatten(tree_like).items():
            if key not in where:
                raise KeyError(f"checkpoint missing leaf {key}")
            # one leaf in host memory at a time
            t = _from_bytes(where[key][key], manifest["leaves"][key])
            want = tuple(like.shape)
            if tuple(t.shape) != want:
                raise ValueError(
                    f"shape mismatch for {key}: {tuple(t.shape)} vs {want}")
            if key in flat_sh and flat_sh[key] is not None:
                t = shard_of(t, flat_sh[key])
            out_flat[key] = t.to(device=like.device, dtype=like.dtype)
    finally:
        for z in shards:
            z.close()
    return _unflatten_like(tree_like, out_flat), step


def _unflatten_like(tree_like, flat: dict[str, Any]):
    def walk(prefix, node):
        if isinstance(node, dict):
            return {
                k: walk(f"{prefix}{SEP}{k}" if prefix else str(k), v)
                for k, v in node.items()
            }
        if isinstance(node, (tuple, list)):
            vals = [
                walk(f"{prefix}{SEP}{i}" if prefix else str(i), v)
                for i, v in enumerate(node)
            ]
            return type(node)(*vals) if hasattr(node, "_fields") else type(node)(vals)
        return flat[prefix]

    return walk("", tree_like)


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(
        d for d in ckpt_dir.iterdir()
        if d.name.startswith("step_") and (d / "COMMITTED").exists()
    )
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(d, ignore_errors=True)
    # clean aborted tmp dirs
    for d in ckpt_dir.glob(".tmp_step_*"):
        shutil.rmtree(d, ignore_errors=True)
