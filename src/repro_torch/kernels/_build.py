"""Build and load the port's hand-written CUDA kernels.

Every `.cu` file under `repro_torch/kernels/*/csrc/` is compiled at first
use into its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so <name>.cu

and loaded with `ctypes` (no PyTorch headers, so a build takes seconds,
not minutes). All sources compile in parallel, one `nvcc` process each.
The output lands in `build/repro_torch_kernels/` at the repository root
(listed in `.gitignore`; override with `REPRO_TORCH_BUILD_DIR`), named by
a hash of the source and the flags so an edited source never loads a
stale library. Nothing here runs at import time: the CPU tests import
every module and never build.
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

__all__ = ["NVCC_FLAGS", "build_dir", "sources", "build_all", "library",
           "library_path", "build_log"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PKG = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}


def build_dir() -> Path:
    """Where the shared libraries go (created on first build)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return _PKG.parents[2] / "build" / "repro_torch_kernels"


def sources() -> dict[str, Path]:
    """Kernel name (the .cu stem) -> source path, for every kernel."""
    return {p.stem: p for p in sorted(_PKG.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (PATH or CUDA_HOME)")


def _target(name: str, src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile (in parallel) and load every kernel not yet loaded.

    Returns {name: seconds} for the libraries built by this call (an
    up-to-date library on disk is loaded without a rebuild and reported
    as 0.0). Raises RuntimeError with nvcc's output if a build fails.
    """
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        if not todo:
            return {}
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs, secs = {}, {}
        t0 = time.perf_counter()
        for name in todo:
            tgt = _target(name, srcs[name])
            if tgt.exists():
                secs[name] = 0.0
                continue
            tmp = tgt.with_suffix(f".{os.getpid()}.tmp.so")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, tgt)
        failed = []
        for name, (proc, tmp, tgt) in procs.items():
            log, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            _LOGS[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode}):\n"
                              f"{log}")
                continue
            os.replace(tmp, tgt)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in todo:
            _LIBS[name] = ctypes.CDLL(str(_target(name, srcs[name])))
        return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building every kernel on the
    first call (one parallel nvcc pass for all sources)."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def library_path(name: str) -> Path:
    """The shared library file of one kernel (built or not)."""
    return _target(name, sources()[name])


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the last
    build of `name` in this process, or "" if it was loaded from disk."""
    return _LOGS.get(name, "")
