"""Builds the port's CUDA sources (``csrc/*.cu``) with nvcc into shared
libraries with a plain C interface, and loads them with ctypes.

The sources include no PyTorch header, so one build takes seconds. Each
library is named after a hash of its sources and lands in ``build/kernels``
at the repository root (listed in ``.gitignore``), with nvcc's output (its
ptxas register, shared memory and spill report) beside it in a ``.log``
of the same name; an edited source is rebuilt on its next use. A missing
nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC))
BUILD_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}  # repolint: ignore[RL003] one dlopen a library


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives once built."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """nvcc's output for the library of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log")


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source not yet built, one nvcc each, all started
    together. Returns the compiler output (with ptxas's register and shared
    memory report) by name, read back from the log of a library built
    before; raises if any build fails."""
    jobs, logs = {}, {}
    try:
        for name in names:
            so = library_path(name)
            if so.exists():
                log = log_path(name)
                logs[name] = (log.read_text() if log.exists()
                              else "(already built)")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, so)
        failed = []
        for name, (proc, tmp, so) in jobs.items():
            logs[name], _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
            else:
                log_path(name).write_text(logs[name])
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
