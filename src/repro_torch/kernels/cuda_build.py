"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` entry points (no
PyTorch headers, so a build takes seconds).  The shared library is built
on first use into ``_build/`` beside this file (listed in ``.gitignore``),
named by a hash of the source, of every ``csrc/`` header it includes
(directly or through another header) and of the flags, so an edited source
or header never loads a stale build.  Nothing here runs at import time: the CPU tests import
every module and have no ``nvcc``.

    from repro_torch.kernels.cuda_build import load
    lib = load("paged_attention")      # builds once per source version
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from typing import Dict, Iterable, List

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "KernelLaunchError", "build",
           "check_launch", "load", "ptxas_log"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_PTXAS: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source on first use")


class KernelLaunchError(RuntimeError):
    """A kernel launch the card refused (``cudaGetLastError() != 0``).
    Never worth a retry: the training loop re-raises it at once."""


def check_launch(err: int, what: str) -> None:
    """Raise :class:`KernelLaunchError` if a C entry point returned a CUDA
    error code (it returns ``cudaGetLastError()`` right after its launch)."""
    if err:
        raise KernelLaunchError(f"{what} launch failed: CUDA error {err}")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> List[pathlib.Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes with
    quotes, followed through headers that include others."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file() and CSRC in dep.parents:
                todo.append(dep)
    return seen


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_sources(name)):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> List[pathlib.Path]:
    """Compile every listed source that has no current build, one
    ``nvcc`` process per source, all started together.  Returns the
    library paths; raises with the compiler's output if any build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        _PTXAS[name] = log
        if proc.returncode:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [_target(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        (path,) = build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


def ptxas_log(name: str) -> str:
    """The compiler's register/shared-memory report of this process's
    build of ``name`` ("" when the library was already built)."""
    return _PTXAS.get(name, "")
