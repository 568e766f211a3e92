"""Native (C++) runtime components, loaded with ctypes
(``horovod_tpu/native``).

Reference: the C++ core in ``horovod/common/``, here the two pieces where
native code earns its keep: the lock-free timeline writer
(``timeline.{h,cc}``) and the rendezvous KV store
(``gloo/http_store.{h,cc}`` + ``runner/http/http_server.py``).  The source
is the port's own copy, ``hvd_native.cc``.

The shared library is built with ``g++`` at first use into the compile
cache's store (``runtime/compile_cache.py``: ``HOROVOD_COMPILE_CACHE_DIR``,
else ``<repo>/build/``, not beside the source), under a name that carries a
hash of the flags, the source and the environment (torch, ``g++
--version``), as ``ops/build.py`` names the CUDA library: an edited source
builds anew, an unchanged one loads without compiling.  The build writes a
temporary file and renames it, so concurrent processes never load half a
library; one that does not load is removed and rebuilt once.  With no
``g++`` the consumers fall back to pure Python, as the JAX package's do; a
build or a load that fails falls back too, with a warning that names the
failure (:func:`native_error` returns it).  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from horovod_tpu_torch.runtime import compile_cache
from horovod_tpu_torch.utils import logging as hvd_logging

SRC = Path(__file__).resolve().parent / "hvd_native.cc"
#: the store's default root (``compile_cache.default_dir()``)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_error: Optional[str] = None
_tried = False


def library_path(build_dir: Optional[Path] = None) -> Path:
    """The store's entry for this source, these flags and this toolchain
    (``build_dir``: the store's root, default the resolved one)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return compile_cache.entry_path("libhvd_torch_native", h.hexdigest(),
                                    toolchain="g++", root=build_dir)


def _compile(lib_path: Path) -> None:
    global build_seconds
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(lib_path)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{proc.stderr.strip()[-2000:]}")
    build_seconds += time.perf_counter() - t0


def _build(lib_path: Path) -> None:
    """Compile the source into the entry ``lib_path`` (a temporary file,
    renamed); raises with the compiler's output when it fails."""
    compile_cache.store_library(lib_path, _compile, toolchain="g++")


#: seconds this process spent compiling the library (0 when it was built)
build_seconds = 0.0


def load() -> Optional[ctypes.CDLL]:
    """The shared library, built on the first call; None when it is not
    available (then :func:`native_error` says why)."""
    global _lib, _error, _tried
    with _lib_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_path = library_path()
        try:
            lib, _ = compile_cache.load_library(
                lib_path, lambda: _build(lib_path))
        except FileNotFoundError as e:
            # no toolchain: the Python fallbacks serve, as in the JAX
            # package
            _error = str(e)
            hvd_logging.debug("native library unavailable (%s); using the "
                              "Python fallbacks", e)
            return None
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            hvd_logging.warning(
                "the native library %s did not build or load (%s); using "
                "the Python fallbacks", lib_path.name, _error)
            return None
        lib.hvdtl_create.restype = ctypes.c_void_p
        lib.hvdtl_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        lib.hvdtl_intern.restype = ctypes.c_int32
        lib.hvdtl_intern.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hvdtl_event.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_char]
        lib.hvdtl_dropped.restype = ctypes.c_uint64
        lib.hvdtl_dropped.argtypes = [ctypes.c_void_p]
        lib.hvdtl_close.argtypes = [ctypes.c_void_p]
        lib.hvdkv_start.restype = ctypes.c_void_p
        lib.hvdkv_start.argtypes = [ctypes.c_int]
        lib.hvdkv_port.restype = ctypes.c_int
        lib.hvdkv_port.argtypes = [ctypes.c_void_p]
        lib.hvdkv_stop.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_built() -> bool:
    """Capability probe (reference ``horovod_nccl_built`` style)."""
    return load() is not None


def native_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded or was not
    tried yet)."""
    return _error


class NativeTimeline:
    """ctypes wrapper with :class:`horovod_tpu_torch.utils.timeline.
    Timeline`'s event API; a producer pays one atomic and two stores an
    event.  Events carry no arguments, as in the JAX package."""

    def __init__(self, filename: str, mark_cycles: bool = False,
                 capacity: int = 65536):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: "
                               f"{native_error()}")
        from horovod_tpu_torch.utils.timeline import ProfilerRangeBridge

        self._lib = lib
        self._mark_cycles = mark_cycles
        self.filename = filename
        # native ts are µs since the writer's start; the wall time at
        # construction is the rebase origin for cross-process aggregation
        self.wall_origin_us = time.time_ns() / 1e3
        self._handle = lib.hvdtl_create(filename.encode(), capacity)
        self._intern_cache: dict = {}
        self._cycle_id = self._intern("CYCLE_START")
        self._closed = False
        self._ranges = ProfilerRangeBridge()

    def _intern(self, s: str) -> int:
        i = self._intern_cache.get(s)
        if i is None:
            i = self._lib.hvdtl_intern(self._handle, s.encode())
            self._intern_cache[s] = i
        return i

    def start_activity(self, tensor_name: str, activity: str) -> None:
        # after close every event is a no-op (dropped, as the Python
        # writer's dead queue drops it): a span opened before
        # stop_timeline may legally close after it, and hvdtl_close frees
        # the writer
        if self._closed:
            return
        self._lib.hvdtl_event(self._handle, self._intern(activity),
                              self._intern(tensor_name), b"B")
        self._ranges.start(tensor_name, activity)

    def end_activity(self, tensor_name: str) -> None:
        if self._closed:
            return
        self._lib.hvdtl_event(self._handle, -1,
                              self._intern(tensor_name), b"E")
        self._ranges.end(tensor_name)

    def instant(self, name: str, args=None) -> None:
        if self._closed:
            return
        self._lib.hvdtl_event(self._handle, self._intern(name), -1, b"i")

    def mark_cycle_start(self) -> None:
        if self._mark_cycles and not self._closed:
            self._lib.hvdtl_event(self._handle, self._cycle_id, -1, b"i")

    @property
    def dropped_events(self) -> int:
        return int(self._lib.hvdtl_dropped(self._handle))

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._ranges.clear()
            self._lib.hvdtl_close(self._handle)


class KvStoreServer:
    """Launcher-side rendezvous KV server (reference ``RendezvousServer``)."""

    def __init__(self, port: int = 0):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: "
                               f"{native_error()}")
        self._lib = lib
        self._handle = lib.hvdkv_start(port)
        if not self._handle:
            raise OSError(f"could not bind KV store on port {port}")

    @property
    def port(self) -> int:
        return self._lib.hvdkv_port(self._handle)

    def stop(self) -> None:
        if self._handle:
            self._lib.hvdkv_stop(self._handle)
            self._handle = None


class KvStoreClient:
    """Blocking client for :class:`KvStoreServer` (reference ``HTTPStore``
    worker side, ``gloo/http_store.cc``): ``get`` waits until the key is
    published, the rendezvous primitive."""

    def __init__(self, host: str, port: int):
        self._addr = (host, port)

    def _roundtrip(self, payload: bytes, read_reply) -> bytes:
        import socket

        with socket.create_connection(self._addr, timeout=60) as s:
            s.sendall(payload)
            return read_reply(s)

    @staticmethod
    def _read_exact(sock, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise EOFError("kv connection closed")
            buf += chunk
        return buf

    def set(self, key: str, value: bytes) -> None:
        k = key.encode()
        payload = (b"S" + len(k).to_bytes(4, "big") + k
                   + len(value).to_bytes(4, "big") + value)
        self._roundtrip(payload, lambda s: self._read_exact(s, 1))

    def get(self, key: str, timeout_ms: int = 60000) -> Optional[bytes]:
        k = key.encode()
        payload = (b"G" + len(k).to_bytes(4, "big") + k
                   + timeout_ms.to_bytes(4, "big"))

        def read(sock):
            vlen = int.from_bytes(self._read_exact(sock, 4), "big")
            if vlen == 0xFFFFFFFF:
                return None
            return self._read_exact(sock, vlen)

        return self._roundtrip(payload, read)

    def num_keys(self) -> int:
        payload = b"D" + (0).to_bytes(4, "big")
        return int.from_bytes(
            self._roundtrip(payload, lambda s: self._read_exact(s, 4)),
            "big")
