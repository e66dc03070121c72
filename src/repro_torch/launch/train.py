"""Trainer of the port: the crash-safe training loop on one device.

Port of ``repro.launch.train``, single-device: the model trains on the
card unless ``--device cpu`` is given (without a card and without that
flag it raises).  Every architecture the port serves trains (the dense
GQA family, granite-moe-3b-a800m, deepseek-v2-lite-16b, mamba2-780m) but
jamba-v0.1-52b; that and ``--mesh`` other than ``1x1`` (FSDP/TP
training) are not ported yet (ROADMAP.md Queue 1 item 12).  Examples:

  # CPU smoke run on learnable synthetic data (plain kernel versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --steps 20 --batch 4 --seq 32 --data arith

  # deepseek-v2-lite-16b (MLA, shared experts, a leading dense layer):
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch deepseek-v2-lite-16b --smoke --device cpu \\
      --quant fp8_lns_pallas --steps 8 --batch 4 --seq 32 --lr 1e-2

  # mamba2-780m (the SSD mixer's six projections through the STE):
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
      --smoke --device cpu --quant fp8_lns_pallas --steps 8 --batch 4 \\
      --seq 32 --lr 1e-2

  # full-width FP8 training through the paper's LNS matmul kernel (K3):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --quant fp8_lns_pallas --steps 6 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import tempfile

import torch

from ..configs import get_config
from ..data.pipeline import DataConfig, Dataset
from ..models import Model
from ..optim import adamw
from ..runtime import fault, steps

__all__ = ["main", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The run's device; CUDA unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port trains on the GPU; pass --device cpu "
            "to run the plain kernel versions on the CPU")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="none")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--data", default="arith",
                    choices=["arith", "synthetic", "memmap"])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL; only 1x1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "kernel versions)")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: FSDP/TP training is not ported yet "
            "(ROADMAP.md Queue 1 item 12)")
    cfg = get_config(args.arch, smoke=args.smoke, quant=args.quant)
    steps.check_trainable(cfg)
    device = resolve_device(args.device)
    model = Model(cfg, max_seq=args.seq)
    opt_cfg = adamw.OptConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps)
    data = Dataset(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, kind=args.data, path=args.data_path))

    def init_state():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return steps.make_train_state(model, gen)

    def to_device(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    state, history = fault.run_training(
        train_step=steps.build_train_step(model, opt_cfg),
        init_state=init_state, dataset=data, max_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        to_device=to_device)
    out = pathlib.Path(args.ckpt_dir) / "history.json"
    out.write_text(json.dumps(history, indent=1))
    print(f"[train:{device}] done: {len(history)} log points -> {out}")
    if len(history) >= 2:
        print(f"[train] loss {history[0]['loss']:.4f} -> "
              f"{history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
