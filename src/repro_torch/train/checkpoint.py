"""Fault-tolerant checkpointing (port of `repro.train.checkpoint`).

  * atomic: writes go to step_<N>.tmp/, fsync'd, flagged
    `checkpoint-complete`, then renamed, so a crash mid-write never
    corrupts the latest checkpoint and an unflagged directory is ignored.
  * async: `save(..., async_=True)` copies every leaf to host memory before
    it returns (torch tensors change in place at the next step, where the
    reference's JAX arrays cannot) and leaves only compression and the
    write to a background thread, which it returns for the caller to join.
  * self-describing, in the port's own format: `index.json` holds each
    leaf's tree path, shape, dtype (bfloat16 included) and compressed size,
    the metadata and the step; `data.bin` holds the raw leaf bytes, zlib-
    compressed leaf by leaf. The reference's msgpack / zstd index is not
    read or written (neither package is on the card's machine).
  * resumable data: the data-pipeline state (the step to replay) rides
    along in the metadata.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import zlib

import torch
from torch.utils import _pytree as pytree

__all__ = ["save", "restore", "latest_step", "prune"]

_FLAG = "checkpoint-complete"
_INDEX = "index.json"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _paths(tree) -> list[str]:
    flat, _ = pytree.tree_flatten_with_path(tree)
    return [pytree.keystr(path) for path, _ in flat]


def save(ckpt_dir: str | os.PathLike, step: int, tree,
         metadata: dict | None = None,
         async_: bool = False) -> threading.Thread | None:
    """Write a tree of tensors ({params, opt_state, ...}) at `step`. With
    async_, the host copies are taken before returning and the write runs
    on the returned (started) thread."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    paths = _paths(tree)
    host = [t.detach().to("cpu", copy=True).contiguous()
            for t in pytree.tree_leaves(tree)]

    def _write():
        tmp = ckpt_dir / f"step_{step:09d}.tmp"
        final = ckpt_dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        leaves = []
        with open(tmp / "data.bin", "wb") as f:
            for path, t in zip(paths, host):
                raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
                comp = zlib.compress(raw, 3)
                leaves.append({"path": path, "shape": list(t.shape),
                               "dtype": _dtype_name(t.dtype),
                               "nbytes": len(comp)})
                f.write(comp)
            f.flush()
            os.fsync(f.fileno())
        with open(tmp / _INDEX, "w") as f:
            json.dump({"codec": "zlib", "leaves": leaves,
                       "metadata": metadata or {}, "step": step}, f)
            f.flush()
            os.fsync(f.fileno())
        (tmp / _FLAG).touch()
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and not p.name.endswith(".tmp") \
                and (p / _FLAG).exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str | os.PathLike, tree_like, step: int | None = None):
    """Restore into the structure of `tree_like` (matched by tree path):
    each leaf comes back on the device of its `tree_like` counterpart, with
    its requires_grad. Returns (tree, metadata)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    final = ckpt_dir / f"step_{step:09d}"
    index = json.loads((final / _INDEX).read_text())
    if index.get("codec") != "zlib":
        raise ValueError(f"{final}: codec {index.get('codec')!r} is not the "
                         "port's zlib format")
    saved = {}
    with open(final / "data.bin", "rb") as f:
        for meta in index["leaves"]:
            raw = bytearray(zlib.decompress(f.read(meta["nbytes"])))
            dtype = getattr(torch, meta["dtype"])
            t = torch.frombuffer(raw, dtype=torch.uint8) if raw else \
                torch.empty(0, dtype=torch.uint8)
            saved[meta["path"]] = t.view(dtype).reshape(meta["shape"])
    like, spec = pytree.tree_flatten(tree_like)
    paths = _paths(tree_like)
    if sorted(paths) != sorted(saved):
        raise ValueError(f"{final}: saved leaves {sorted(saved)} do not "
                         f"match the tree's {sorted(paths)}")
    out = [saved[p].to(l.device).requires_grad_(l.requires_grad)
           for p, l in zip(paths, like)]
    return pytree.tree_unflatten(out, spec), index["metadata"]


def prune(ckpt_dir: str | os.PathLike, keep: int = 3):
    """Retain the newest `keep` complete checkpoints."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    steps = sorted(
        int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
        if p.name.startswith("step_") and not p.name.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:09d}", ignore_errors=True)
