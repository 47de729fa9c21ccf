"""Build and load the port's CUDA kernels (`walkai_nos_tpu_torch/csrc`).

Each `csrc/*.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with `ctypes` (no PyTorch
headers: a build takes seconds, not minutes). Builds happen at first
use, never at import, into `walkai_nos_tpu_torch/_kernels_build/`
(gitignored); a library is keyed by the hash of its source and of every
shared header in `csrc/` (`*.cuh`), so an edited kernel or header
rebuilds and an unchanged one loads from disk. All sources build in
parallel, one `nvcc` process each, started together.

A build that fails raises with the compiler's output; there is no
fallback to a plain path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["BUILD_DIR", "CSRC_DIR", "KERNEL_SOURCES", "load_kernels"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_kernels_build")
KERNEL_SOURCES = (
    "paged_attention", "qkv_rope", "flash_attention", "flash_attention_bwd",
    "decode_attention", "graph_fold",
)

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# The compiler's report (ptxas registers / shared memory) of each source
# built by this process.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256()
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            digest.update(src.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def load_kernels() -> dict[str, ctypes.CDLL]:
    """Build (where needed) and load every kernel library; returns
    {source name: CDLL}. Thread-safe, idempotent per process."""
    with _lock:
        if len(_loaded) == len(KERNEL_SOURCES):
            return _loaded
        os.makedirs(BUILD_DIR, exist_ok=True)
        todo = {
            name: _lib_path(name) for name in KERNEL_SOURCES
            if not os.path.exists(_lib_path(name))
        }
        if todo:
            nvcc = _nvcc()
            procs = {}
            for name, out in todo.items():
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = [
                    nvcc, *_NVCC_FLAGS, "-o", tmp,
                    os.path.join(CSRC_DIR, name + ".cu"),
                ]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ), tmp, out)
            failed = []
            for name, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                build_logs[name] = log
                if proc.returncode != 0:
                    failed.append(f"--- {name}.cu ---\n{log}")
                    continue
                os.replace(tmp, out)
            if failed:
                raise RuntimeError(
                    "CUDA kernel build failed:\n" + "\n".join(failed)
                )
        for name in KERNEL_SOURCES:
            _loaded[name] = ctypes.CDLL(_lib_path(name))
        return _loaded
