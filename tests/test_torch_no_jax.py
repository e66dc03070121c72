"""The port imports neither JAX nor the JAX package: every module of
``repro_torch`` imports in a fresh interpreter where ``jax`` and ``repro``
cannot be imported (``sys.modules[name] = None`` makes any import of them
raise)."""
import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

PROBE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import repro_torch
names, failed = ["repro_torch"], []
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.",
                                  onerror=failed.append):
    names.append(info.name)
for name in names:
    try:
        importlib.import_module(name)
    except Exception as e:
        failed.append(f"{name}: {type(e).__name__}: {e}")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
print(len(names))
print("MODULES", " ".join(names))
for line in failed + leaked:
    print("FAIL", line)
"""


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert not [line for line in lines if line.startswith("FAIL")], lines
    assert int(lines[0]) >= 40, lines  # every subpackage was walked
    modules = lines[1].split()[1:]
    assert "repro_torch.models.moe" in modules, modules
    assert "repro_torch.models.mamba2" in modules, modules
    assert "repro_torch.configs.jamba_v01_52b" in modules, modules
