"""The port stands alone: no module of ``repro_torch`` (or
``chip_smoke.py``) imports JAX or the JAX package ``repro``."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
sys.path.insert(0, sys.argv[1])
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
               for m in sys.modules), "a blocked module slipped in"
print(len(names))
"""


def test_every_module_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, ROOT],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module was walked


def test_no_source_line_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[ .])")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = []
    for p in files:
        with open(p) as f:
            hits += [f"{p}:{i}" for i, line in enumerate(f, 1)
                     if pat.match(line)]
    assert not hits, hits
