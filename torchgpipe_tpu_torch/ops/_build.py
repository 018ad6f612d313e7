"""Build and load the CUDA kernels under ``torchgpipe_tpu_torch/csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``build/<name>_<hash>.so``, keyed by a
hash of the sources and flags, then loads with ``ctypes`` (pointers and
the stream as ``c_void_p``).  No PyTorch headers are involved, so a
build takes seconds.  :func:`build_all` starts one ``nvcc`` per source,
all at once.  A failed build raises; nothing falls back to the plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME); the CUDA "
        "kernels of torchgpipe_tpu_torch need the CUDA toolkit to build"
    )


def so_path(name: str) -> str:
    """The built shared library of ``csrc/<name>.cu`` (keyed by a hash of
    the sources and flags)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [
        os.path.join(CSRC, name + ".cu")
    ]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def log_path(name: str) -> str:
    """nvcc's output (with the ptxas register/spill report) for a build."""
    return so_path(name) + ".log"


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC, "*.cu"))
    )


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile every kernel source not yet built, one ``nvcc`` process
    per source, all started together.  Returns seconds per built name.
    Raises with the compiler's output when any build fails."""
    names = sources() if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        so = so_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, so)
    secs: Dict[str, float] = {}
    failed = []
    try:
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate(timeout=600)
            secs[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (rc={proc.returncode})\n{out}")
                continue
            with open(log_path(name), "w") as f:
                f.write(out)
            os.replace(tmp, so)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            so = so_path(name)
            if not os.path.exists(so):
                build_all([name])
            _libs[name] = ctypes.CDLL(so)
        return _libs[name]


def function(name: str, symbol: str, argtypes: list) -> Callable[..., int]:
    """C entry point ``symbol`` of ``csrc/<name>.cu``, returning ``int``,
    with its argument types set once."""
    key = f"{name}:{symbol}"
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[key] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
