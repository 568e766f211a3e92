"""Build the port's CUDA kernels on first use and load them with ctypes.

The library is what the ``hvd_torch`` ops' CUDA kernels call
(``ops/kernels.py``): every ``csrc/*.cu`` source is compiled by its own
``nvcc`` process, all started together, into an object file; one link
step then makes a single shared library with a plain C interface
(:data:`_SIGNATURES`; the TMA kernels look the CUDA driver's
``cuTensorMapEncodeTiled`` up at run time, so nothing beyond the CUDA
runtime is linked).  The library is an entry of the compile cache's disk
layer (``runtime/compile_cache.py``): its name carries a hash of the
flags, of every source and header in ``csrc/`` (``*.cu`` and ``*.cuh``) and
of the environment (torch, the CUDA runtime, ``nvcc --version``, the card),
so an edited source or header builds anew and an unchanged tree is loaded
from the store (``HOROVOD_COMPILE_CACHE_DIR``, else ``<repo>/build/``,
resolved at each call) without compiling.  A library that does not load is
rebuilt once; a second failure raises.  Nothing here runs at import time:
the CPU tests import every module of the port.
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
from typing import Optional

from horovod_tpu_torch.runtime import compile_cache

CSRC = Path(__file__).resolve().parent / "csrc"
#: the store's default root (``compile_cache.default_dir()``)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# -Xptxas -v: registers, shared memory and spills of every kernel, kept
# beside the library as <library>.log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds this process spent compiling (0 when the library was built)
build_seconds = 0.0
#: whether this process loaded the library from the store without
#: compiling it (None before the load)
library_hit: Optional[bool] = None

_c_void_p, _c_int, _c_float, _c_int64 = (ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_int64)
_SIGNATURES = {
    "hvd_fused_scale": [_c_void_p, _c_void_p, _c_int64, _c_float, _c_int,
                        _c_int, _c_void_p],
    "hvd_flash_fwd": [_c_void_p] * 7 + [_c_int] * 4 + [_c_float, _c_int,
                                                       _c_void_p],
    "hvd_flash_bwd_dq": [_c_void_p] * 10 + [_c_int] * 4 + [_c_float, _c_int,
                                                           _c_void_p],
    "hvd_flash_bwd_dkv": [_c_void_p] * 10 + [_c_int] * 4 + [_c_float, _c_int,
                                                            _c_void_p],
    "hvd_cbr_bwd": [_c_void_p] * 14 + [_c_int] * 7 + [_c_void_p],
    "hvd_matmul": [_c_void_p] * 3 + [_c_int] * 6 + [_c_void_p],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source with the CUDA toolkit")


def _sources():
    """The compile units, ``csrc/*.cu``; headers are only included."""
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags and of every ``csrc/*.cu`` and ``*.cuh``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(build_dir: Optional[Path] = None) -> Path:
    """The store's entry for these sources, flags, toolchain and card
    (``build_dir``: the store's root, default the resolved one)."""
    return compile_cache.entry_path("libhvd_torch_kernels", _digest(),
                                    toolchain=_nvcc(), card=True,
                                    root=build_dir)


def _compile(lib_path: Path) -> str:
    """Compile the sources (in parallel) and link them into ``lib_path``;
    returns the compiler's report (kept beside the entry as its ``.log``),
    raises with it when a build fails."""
    global build_seconds
    build_dir = lib_path.parent
    sources = _sources()
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs = [build_dir / f"{src.stem}.{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    failures, log = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        log.append(f"{src.name}:\n{out}")
        if proc.returncode != 0:
            failures.append(log[-1])
    if failures:
        for obj in objs:
            obj.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    link = subprocess.run([nvcc, "-shared", "-o", str(lib_path),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    build_seconds += time.perf_counter() - t0
    return "\n".join(log)


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile the library into the store unless its entry is there;
    returns the entry's path."""
    lib_path = library_path(build_dir)
    if not lib_path.exists():
        compile_cache.store_library(lib_path, _compile,
                                    toolchain=_nvcc(), card=True)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, library_hit
    with _lock:
        if _lib is None:
            lib, library_hit = compile_cache.load_library(library_path(),
                                                          build)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
