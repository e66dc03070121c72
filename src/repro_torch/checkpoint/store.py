"""Atomic, asynchronous checkpointing of the train state, written with
numpy.  Port of ``save``/``latest_step``/``restore`` of
``repro.checkpoint.store``, with its directory layout:

  * leaves are keyed by their "/"-joined tree path (``params/blocks/0/
    attn/wq``) and saved as ``.npy`` files beside a ``manifest.json``;
  * writes go to ``<dir>/tmp-<step>`` and are renamed to
    ``<dir>/step-<step>`` when complete, so a crash mid-write never
    corrupts the latest checkpoint; only the newest ``KEEP_LAST`` stay;
  * the snapshot is copied to host memory synchronously and the files are
    written on a background thread; ``save`` returns a future whose
    ``.result()`` waits for the write;
  * the data-pipeline state and the step ride in the manifest, so a
    restart resumes the exact batch sequence.

Leaves are tensors whose dtype numpy holds (the train state is float32
master weights and moments plus an int32 step).  The serving snapshots'
``restore_raw`` is not ported yet.
"""
from __future__ import annotations

import concurrent.futures
import json
import pathlib
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["save", "latest_step", "restore"]

_EXEC = concurrent.futures.ThreadPoolExecutor(max_workers=1)
KEEP_LAST = 3


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"/"-joined path: leaf} of nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten_like(like, flat: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, flat, f"{prefix}/{i}" if prefix
                                          else str(i))
                          for i, v in enumerate(like))
    return flat[prefix]


def save(ckpt_dir, state, *, step: int, data_state: Optional[dict] = None
         ) -> concurrent.futures.Future:
    """Snapshot ``state`` (a tree of tensors) at ``step``.  Returns a
    future; ``.result()`` waits until the checkpoint is on disk."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    flat = {k: v.detach().cpu().numpy() for k, v in _flatten(state).items()}

    def _write():
        tmp = ckpt_dir / f"tmp-{step}"
        final = ckpt_dir / f"step-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "data_state": data_state or {},
                    "leaves": {}}
        for i, (key, arr) in enumerate(sorted(flat.items())):
            fname = f"leaf{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {"file": fname,
                                       "shape": list(arr.shape),
                                       "dtype": str(arr.dtype)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        steps = sorted(int(p.name.split("-")[1])
                       for p in ckpt_dir.glob("step-*"))
        for s in steps[:-KEEP_LAST]:
            shutil.rmtree(ckpt_dir / f"step-{s}", ignore_errors=True)

    return _EXEC.submit(_write)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = [int(p.name.split("-")[1])
             for p in pathlib.Path(ckpt_dir).glob("step-*")]
    return max(steps) if steps else None


def restore(ckpt_dir, like):
    """Load the latest checkpoint into the structure of ``like`` (a tree
    of tensors whose shapes, dtypes and devices the loaded leaves take).
    Returns (state, step, data_state)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step-{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat_like = _flatten(like)
    loaded = {}
    for key, meta in manifest["leaves"].items():
        if key not in flat_like:
            raise KeyError(f"checkpoint leaf {key!r} not in target structure")
        want = flat_like[key]
        arr = np.load(d / meta["file"])
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(want.shape)}")
        loaded[key] = torch.from_numpy(arr).to(device=want.device,
                                               dtype=want.dtype)
    missing = set(flat_like) - set(loaded)
    if missing:
        raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]} ...")
    return (_unflatten_like(like, loaded), manifest["step"],
            manifest.get("data_state", {}))
