"""Atomic, asynchronous checkpointing, written with numpy.  Port of
``save``/``latest_step``/``restore``/``restore_raw``/``path_key`` of
``repro.checkpoint.store``, with its directory layout:

  * leaves are keyed by their "/"-joined tree path (``params/blocks/0/
    attn/wq``, :func:`path_key`) and saved as ``.npy`` files beside a
    ``manifest.json``;
  * writes go to ``<dir>/tmp-<step>`` and are renamed to
    ``<dir>/step-<step>`` when complete, so a crash mid-write never
    corrupts the latest checkpoint; only the newest ``KEEP_LAST`` stay;
  * the snapshot is copied to host memory synchronously and the files are
    written on a background thread; ``save`` returns a future whose
    ``.result()`` waits for the write;
  * the data-pipeline state and the step ride in the manifest, so a
    restart resumes the exact batch sequence.

Leaves keep their bits whatever their dtype: numpy has no bfloat16, so a
bf16 leaf is saved as its 16-bit pattern (``view(torch.int16)``) with
``"bfloat16"`` as its dtype in the manifest, and viewed back on load
(the serving snapshots' bf16 pages and spills).  :func:`restore` loads
into the structure of a ``like`` tree (the train state);
:func:`restore_raw` loads without one, for the serving snapshots, whose
tree (the preempted requests' spills) is recorded in the manifest's
``data_state``.
"""
from __future__ import annotations

import concurrent.futures
import json
import pathlib
import shutil
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["save", "latest_step", "restore", "restore_raw", "path_key"]

_EXEC = concurrent.futures.ThreadPoolExecutor(max_workers=1)
KEEP_LAST = 3


def path_key(path: Sequence) -> str:
    """Canonical "/"-joined string key of one tree path (dict keys and
    list positions): the checkpoint addressing scheme."""
    return "/".join(str(p) for p in path)


def _flatten(tree, path: tuple = ()) -> Dict[str, Any]:
    """{path_key: leaf} of nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path_key(path): tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, path + (k,)))
    return flat


def _unflatten_like(like, flat: Dict[str, Any], path: tuple = ()):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, path + (k,))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, flat, path + (i,))
                          for i, v in enumerate(like))
    return flat[path_key(path)]


def _host_array(t: torch.Tensor):
    """(a numpy copy of ``t``'s bits, the dtype name for the manifest)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:  # numpy has no bf16: keep its bits
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _load_leaf(d: pathlib.Path, meta: dict) -> torch.Tensor:
    """One leaf as a CPU tensor of its saved dtype, bit for bit."""
    t = torch.from_numpy(np.load(d / meta["file"]))
    return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t


def save(ckpt_dir, state, *, step: int, data_state: Optional[dict] = None
         ) -> concurrent.futures.Future:
    """Snapshot ``state`` (a tree of tensors) at ``step``.  Returns a
    future; ``.result()`` waits until the checkpoint is on disk."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    flat = {k: _host_array(v) for k, v in _flatten(state).items()}

    def _write():
        tmp = ckpt_dir / f"tmp-{step}"
        final = ckpt_dir / f"step-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "data_state": data_state or {},
                    "leaves": {}}
        for i, (key, (arr, dtype)) in enumerate(sorted(flat.items())):
            fname = f"leaf{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {"file": fname,
                                       "shape": list(arr.shape),
                                       "dtype": dtype}
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


def restore_raw(ckpt_dir, *, step: Optional[int] = None
                ) -> tuple[Dict[str, torch.Tensor], dict]:
    """Load a checkpoint (the latest, or ``step``) as ``({path_key: CPU
    tensor}, manifest)`` without a target structure: the caller
    reassembles what it needs from the keys and the manifest's
    ``data_state``."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step-{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = {key: _load_leaf(d, meta)
            for key, meta in manifest["leaves"].items()}
    return flat, manifest


def restore(ckpt_dir, like):
    """Load the latest checkpoint into the structure of ``like`` (a tree
    of tensors whose shapes, dtypes and devices the loaded leaves take).
    Returns (state, step, data_state)."""
    flat, manifest = restore_raw(ckpt_dir)
    flat_like = _flatten(like)
    loaded = {}
    for key, t in flat.items():
        if key not in flat_like:
            raise KeyError(f"checkpoint leaf {key!r} not in target structure")
        want = flat_like[key]
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                             f"{tuple(want.shape)}")
        loaded[key] = t.to(device=want.device, dtype=want.dtype)
    missing = set(flat_like) - set(loaded)
    if missing:
        raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]} ...")
    return (_unflatten_like(like, loaded), manifest["step"],
            manifest.get("data_state", {}))
