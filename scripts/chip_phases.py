#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` on one CUDA device, in one or
more checkouts of this repository, each checkout in its own process.

    python3 scripts/chip_phases.py [--root ROOT ...] PHASE [PHASE ...]

A PHASE is the name of a function of ``chip_smoke.py`` that takes the
device alone (``ssm_path``, ``check_ssm_kernels``, ``mla_path``,
``mla_train_path``, ``check_mla_train_against_plain``, ``ssm_train_path``,
``hybrid_path``, ...).  Each ROOT
(default: this checkout) runs in the order given, so ``--root parent
--root . --root . --root parent`` compares two commits on one card in
turns.  A child process imports that checkout's ``src/repro_torch`` and
``chip_smoke.py`` (nothing of JAX), sets up the card as ``chip_smoke.main``
does (cuBLAS without split-K, TF32 off), builds every kernel source of
that checkout, then runs the phases in order, each printing its own lines
and its wall (``chip_smoke._phase``).  The card's name and power limit are
printed first; the exit code is the first failing child's.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys


def child(root: str, phases) -> None:
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import cuda_build
    from repro_torch.launch.mesh import require_column_stable_cublas

    require_column_stable_cublas("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"# {root}: {cs.card_line()}", flush=True)
    cuda_build.build(cs.KERNEL_SOURCES)
    for name in phases:
        cs._phase(getattr(cs, name), dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=None,
                    help="a checkout's root (repeatable; default: this one)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child, args.phases)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = 0
    for root in args.root or [here]:
        root = os.path.abspath(root)
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", root, *args.phases], cwd=root)
        print(f"# {root}: exit {done.returncode}", flush=True)
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
