"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``. The libraries land in ``build/repro_torch/<hash>/`` at the
repository root, where ``<hash>`` covers every source and the compiler
flags: editing a kernel builds a fresh directory, and an unchanged tree
reuses what is there. All sources compile in parallel, one nvcc each, on
first use; nothing is built when the module is imported.

Every exported launcher takes its pointers, sizes and the CUDA stream and
returns ``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fingerprint", "masked_cumsum", "keep_mask")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or the
    toolkit's default prefix. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> Path:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{"dir", "seconds", "built", "ptxas"}``: ``ptxas`` maps each
    freshly built source to the compiler's resource report (registers,
    shared memory, spills). Raises RuntimeError with nvcc's output when a
    source does not compile."""
    with _lock:
        return _build_locked()


def _build_locked() -> dict:
    out_dir = build_dir()
    todo = [s for s in SOURCES if not (out_dir / f"lib{s}.so").exists()]
    t0 = time.perf_counter()
    procs = {}
    if todo:
        nvcc = nvcc_path()
        out_dir.mkdir(parents=True, exist_ok=True)
    for s in todo:
        tmp = out_dir / f"lib{s}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{s}.cu")]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    ptxas, failed = {}, []
    for s, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {s}.cu (exit {proc.returncode})\n{log}")
            continue
        ptxas[s] = log
        os.replace(tmp, out_dir / f"lib{s}.so")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {"dir": str(out_dir), "seconds": time.perf_counter() - t0,
            "built": todo, "ptxas": ptxas}


def kernel_fn(source: str, symbol: str, argtypes: list):
    """The exported C launcher ``symbol`` of ``csrc/<source>.cu``, built
    and loaded on first use, with its ctypes signature declared."""
    key = (source, symbol)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = build_dir() / f"lib{source}.so"
            if not path.exists():
                _build_locked()
            lib = _libs[source] = ctypes.CDLL(str(path))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(rc: int, source: str, what: str) -> None:
    """Raise RuntimeError when a launcher returned a CUDA error code."""
    if rc != 0:
        msg = _libs[source].repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
