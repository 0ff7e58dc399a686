"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each source under ``kernels/csrc/`` has a plain C interface and is compiled
for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared library
that ``ctypes`` loads; no PyTorch headers are involved, so a build takes
seconds. Libraries go to ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``), named by the hash of their source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source rebuilds and an
unchanged one loads the library already there. Only the sources in the checkout are built; a machine with a card
but no ``nvcc`` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared by several sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` on ``csrc/<name>.cu`` into a temporary file beside the
    library's final path. Returns (name, temporary path, process)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, tmp, proc


def build_all(names: Iterable[str] = None) -> Dict[str, str]:
    """Compile every listed source (default: all of ``csrc/*.cu``) whose
    library is missing, one ``nvcc`` per source, all started together, and
    move each finished library into place atomically. Returns
    ``{name: compiler output}`` for the sources it compiled; raises with
    the compiler's output if one fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    logs = {}
    with _lock:
        jobs = [_start(n) for n in names if not _lib_path(n).exists()]
        try:
            for name, tmp, proc in jobs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on csrc/{name}.cu "
                        f"(exit {proc.returncode}):\n{log}")
                os.replace(tmp, _lib_path(name))
                logs[name] = log
        finally:
            for _, tmp, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all([name])
    with _lock:
        lib = _loaded.setdefault(name, ctypes.CDLL(str(path)))
    return lib
