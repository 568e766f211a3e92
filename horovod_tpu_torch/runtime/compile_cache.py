"""Warm-start compile cache of the port
(``horovod_tpu/runtime/compile_cache.py``).

The JAX package keeps two layers: XLA's persistent compilation cache and
an AOT store of serialized executables, keyed by a hash of the lowered
StableHLO text.  The port compiles its kernel library (``ops/build.py``,
``nvcc``) and its native library (``native/``, ``g++``), and, ahead of
time, exported programs (AOTInductor packages), which call the kernels
as ``hvd_torch`` ops; a captured ``torch.cuda.CUDAGraph`` stands in for
an executable within a process.  So the port's layers are:

1. **The disk layer** — one store, its root :func:`resolve_dir`'s:
   ``HOROVOD_COMPILE_CACHE_DIR`` when set, else ``<repo>/build/``
   (:func:`default_dir`).  ``HOROVOD_COMPILE_CACHE=0`` builds into a
   directory of the process, removed at exit: every start compiles, as a
   disabled store does in JAX.  ``aot_disk_hits``/``aot_disk_misses``
   count a process's loads from the store against its builds, libraries
   and executables alike.

   * **Libraries**: an entry is ``<stem>_<key>.so``, whose key hashes the
     flags, the sources and the environment fields (:func:`_env_fields`:
     torch, the CUDA runtime, the compiler's ``--version`` and, for the
     CUDA library, the card's name and capability); a ``.json`` meta
     beside it records the same fields.  A build writes a temporary file
     and renames it, so two processes that build one entry at once both
     load a whole library (:func:`store_library`).  A load touches the
     entry (LRU recency); :func:`prune` evicts the least recently used
     beyond a capacity it is given (nothing prunes libraries on its own:
     the store holds one entry a build).  A library that does not load is
     removed and rebuilt once, with a warning (:func:`load_library`).
   * **Executables** (JAX's AOT store): :func:`aot_compile` exports a
     function with ``torch.export``, keys it by a hash of the graph's text
     (:func:`export_key`), and loads ``<root>/aot/<key>.pt2`` or compiles
     it with ``torch._inductor.aoti_compile_and_package`` and stores it
     (:func:`store_executable`, a rename), pruning the entries by mtime
     beyond ``cache_capacity`` after every store
     (:func:`prune_executables`).  A package that does not load is
     removed, compiled again and logged (:func:`load_executable`); an
     export or compile that fails raises.  Weights are inputs of the
     exported function, never packaged.
2. **The in-memory layer** — :class:`ExecutableLRU`, the captured graphs
   (:func:`capture`, :class:`CapturedGraph`) of the training step's
   ``steps_per_call`` and of the serving executors (``serve/batcher.py``),
   keyed by :func:`executable_key` or by what a graph was captured with,
   bounded by ``cache_capacity`` (the step keeps one graph: its pool holds
   the step's activations and gradients), every lookup counted in ``hits``/
   ``misses`` and ``hvd_compile_cache_{hits,misses}_total``.  The kernel
   wrappers' launch counts (``ops/kernels.py``) stay the launches that
   ran: a capture takes out what it recorded, and each replay adds it.

Nothing here runs at import time.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable, Optional, Tuple

from horovod_tpu_torch.utils import logging as hvd_logging

_META_SUFFIX = ".json"
_lock = threading.Lock()
# process-wide counters; mirrored into GlobalState.cache_stats when the
# runtime is initialized so hvd.cache_stats() surfaces them
_stats = {"aot_disk_hits": 0, "aot_disk_misses": 0}
# seconds this process spent in aot_compile's stages
_aot_seconds = {"export": 0.0, "compile": 0.0, "load": 0.0}
# the disabled store's directory of this process (removed at exit)
_private_dir: Optional[str] = None
# the entries this process compiled: a load of one of them is a miss
_built: set = set()


def default_dir() -> str:
    """The default store root: ``<repo>/build/``, where the kernel and
    native libraries have always been built."""
    return str(Path(__file__).resolve().parents[2] / "build")


def resolve_dir(config=None) -> Optional[str]:
    """The active store root, or ``None`` when the store is disabled.

    Resolution order: explicit ``config`` → the initialized runtime's
    config → the raw env knobs (so the store works before ``hvd.init()``,
    as the kernels build before it)."""
    if config is None:
        from horovod_tpu_torch.runtime import state as rt_state

        if rt_state.is_initialized():
            config = rt_state.global_state().config
    if config is not None:
        if not getattr(config, "compile_cache_enabled", True):
            return None
        return getattr(config, "compile_cache_dir", None) or default_dir()
    v = os.environ.get("HOROVOD_COMPILE_CACHE", "")
    if v.lower() in ("0", "false", "no", "off"):
        return None
    return os.environ.get("HOROVOD_COMPILE_CACHE_DIR") or default_dir()


def _private_store() -> Path:
    """A directory of this process, removed at exit."""
    global _private_dir
    with _lock:
        if _private_dir is None:
            _private_dir = tempfile.mkdtemp(prefix="hvd_compile_")
            atexit.register(shutil.rmtree, _private_dir, True)
        return Path(_private_dir)


def store_dir() -> Path:
    """Where a library is built and loaded from: the active root, or,
    with the store disabled, a directory of this process that is removed
    at exit."""
    root = resolve_dir()
    return _private_store() if root is None else Path(root)


def enable_persistent_cache(directory: Optional[str] = None,
                            config=None) -> Optional[str]:
    """Make the store's root (JAX's name: there it also points XLA's
    persistent cache there; the port has no XLA).  Returns the active
    root, or ``None`` when disabled."""
    root = directory or resolve_dir(config)
    if root is None:
        return None
    try:
        os.makedirs(root, exist_ok=True)
    except OSError as e:
        hvd_logging.warning("compile_cache: store root %s unavailable (%s)",
                            root, e)
        return None
    return root


def stats() -> dict:
    """Disk-store counters: ``{"aot_disk_hits": n, "aot_disk_misses": n}``."""
    with _lock:
        return dict(_stats)


def aot_seconds() -> dict:
    """Seconds this process spent exporting, compiling and loading AOT
    executables (:func:`aot_compile`), each stage summed."""
    with _lock:
        return dict(_aot_seconds)


def _timed(stage: str, fn, *args, **kwargs):
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        with _lock:
            _aot_seconds[stage] += time.perf_counter() - t0


def _bump(hit: bool) -> None:
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.runtime import state as rt_state

    name = "aot_disk_hits" if hit else "aot_disk_misses"
    with _lock:
        _stats[name] += 1
    telemetry.counter(
        "hvd_aot_disk_hits_total" if hit else "hvd_aot_disk_misses_total",
        "persistent AOT executable store hits" if hit
        else "persistent AOT executable store misses").inc()
    if rt_state.is_initialized():
        cs = rt_state.global_state().cache_stats
        cs[name] = cs.get(name, 0) + 1


def _count_memory(hit: bool) -> None:
    """One lookup of the in-memory layer, as JAX's step counts its LRU."""
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.runtime import state as rt_state

    if hit:
        telemetry.counter("hvd_compile_cache_hits_total",
                          "in-memory executable-cache hits").inc()
    else:
        telemetry.counter("hvd_compile_cache_misses_total",
                          "in-memory executable-cache misses").inc()
    if rt_state.is_initialized():
        rt_state.global_state().cache_stats["hits" if hit else "misses"] += 1


@functools.lru_cache(maxsize=None)
def _toolchain_version(tool: Optional[str]) -> Optional[str]:
    """What ``<tool> --version`` prints, its whitespace collapsed (nvcc
    names its release on its last line), or None without the tool."""
    if tool is None:
        return None
    path = tool if os.path.sep in tool else shutil.which(tool)
    if path is None:
        return None
    try:
        out = subprocess.run([path, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return " ".join(out.split())


def _card_fields(device=None) -> Optional[dict]:
    import torch

    if not torch.cuda.is_available():
        return None
    idx = torch.cuda.current_device() if device is None else device
    major, minor = torch.cuda.get_device_capability(idx)
    return {"name": torch.cuda.get_device_name(idx),
            "capability": f"{major}.{minor}"}


def _env_fields(toolchain: Optional[str] = None, card: bool = False,
                device=None) -> dict:
    """The identity fields of an entry: what can change generated code or
    what a library links against without changing its sources.  The card
    is asked for only where ``card`` (the CUDA library, a captured graph):
    the native library is host code, and asking would start CUDA in a
    process that may fork."""
    import torch

    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "toolchain": _toolchain_version(toolchain),
            "card": _card_fields(device) if card else None}


# default object repr / bound-method repr memory addresses: a key built
# from them differs every process start, so every warm start misses
_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")


def _stable_repr(obj: Any) -> str:
    """Process-stable fallback serializer for non-JSON key fields
    (JAX's): ``repr`` with its memory address stripped."""
    return _ADDR_RE.sub("", repr(obj))


def _tensor_sig(t) -> list:
    return [list(t.shape), str(t.dtype), str(t.device)]


def _batch_sig(batch) -> Any:
    import torch

    if isinstance(batch, torch.Tensor):
        return _tensor_sig(batch)
    if isinstance(batch, dict):
        return {str(k): _batch_sig(v) for k, v in sorted(batch.items())}
    if isinstance(batch, (list, tuple)):
        return [_batch_sig(v) for v in batch]
    return _stable_repr(batch)


def _optimizer_sig(optimizer) -> Optional[dict]:
    """The class of the optimizer that steps (and of every wrapper around
    it) and each param group's hyperparameters: lr, betas, eps,
    weight_decay, capturable, ...  A tensor hyperparameter (an lr on the
    card) enters by its signature, not its value: a graph reads its value
    at each replay."""
    import torch

    if optimizer is None:
        return None
    classes = []
    inner = optimizer
    while inner is not None:
        classes.append(type(inner).__qualname__)
        inner = inner.__dict__.get("optimizer")
    groups = [{k: ["tensor"] + _tensor_sig(v)
               if isinstance(v, torch.Tensor) else v
               for k, v in g.items() if k != "params"}
              for g in optimizer.param_groups]
    return {"classes": classes, "param_groups": groups}


@functools.lru_cache(maxsize=1)
def _kernel_digest() -> str:
    from horovod_tpu_torch.ops import build

    return build._digest()


def executable_key(extras: Optional[dict] = None, *, model=None,
                   optimizer=None, batch=None) -> str:
    """Content hash identifying one captured executable.

    There is no lowered text to hash: the key covers what shapes a
    captured step — the kernel library's digest, the environment fields,
    ``extras`` (the step's ``_aot_extras``: plan, mode, hierarchy,
    ``steps_per_call``, ...), the model's parameter and buffer names,
    shapes, dtypes and devices in order, the optimizer's classes and its
    param groups' hyperparameters (a scheduler's new lr is a new key), and
    the batch's signature."""
    device = None
    if model is not None:
        first = next(iter(model.parameters()), None)
        if first is not None and first.is_cuda:
            device = first.device
    payload = {
        "kernels": _kernel_digest(),
        "env": _env_fields(card=device is not None, device=device),
        "extras": extras or {},
        "model": None if model is None else [
            [name] + _tensor_sig(t) for name, t in
            [*model.named_parameters(), *model.named_buffers()]],
        "optimizer": _optimizer_sig(optimizer),
        "batch": None if batch is None else _batch_sig(batch),
    }
    blob = json.dumps(payload, sort_keys=True, default=_stable_repr)
    return hashlib.sha256(blob.encode()).hexdigest()


# -- the disk layer ----------------------------------------------------------

def entry_path(stem: str, digest: str, toolchain: Optional[str] = None,
               card: bool = False, root: Optional[Path] = None) -> Path:
    """The entry of a library: ``<root>/<stem>_<key>.so``, the key a hash
    of ``digest`` (flags and sources) and the environment fields."""
    root = store_dir() if root is None else Path(root)
    env = json.dumps(_env_fields(toolchain, card), sort_keys=True)
    key = hashlib.sha256(f"{digest}\n{env}".encode()).hexdigest()[:16]
    return root / f"{stem}_{key}.so"


def _entry_files(path: Path) -> Tuple[Path, Path, Path]:
    return path, path.with_suffix(".log"), path.with_suffix(_META_SUFFIX)


def _remove_entry(path: Path) -> None:
    for f in _entry_files(path):
        f.unlink(missing_ok=True)


def _touch(path: Path) -> None:
    for f in _entry_files(path):
        try:
            os.utime(f, None)
        except OSError:
            pass


def open_library(path: Path) -> Optional[ctypes.CDLL]:
    """The library stored at ``path``, or ``None`` on a miss.  A load
    touches the entry (LRU recency); a file that does not load is removed
    with its log and meta, with a warning, and ``None`` is returned."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        hvd_logging.warning(
            "compile_cache: could not load %s (%s); rebuilding",
            path.name, e)
        _remove_entry(path)
        return None
    _touch(path)
    return lib


def store_library(path: Path,
                  compile_into: Callable[[Path], Optional[str]],
                  toolchain: Optional[str] = None,
                  card: bool = False) -> None:
    """Build the entry at ``path``: ``compile_into(tmp)`` writes the
    library to a temporary file of this process, which is renamed into
    place (so a concurrent loader never sees half a file); the compiler's
    report it returns, if any, becomes the entry's ``.log``; then the
    ``.json`` meta with the environment fields is written the same way."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = path.with_name(f".tmp.{path.name}.{tag}")
    try:
        report = compile_into(tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    if report is not None:
        path.with_suffix(".log").write_text(report)
    meta = path.with_suffix(_META_SUFFIX)
    tmp_meta = meta.with_name(f".tmp.{meta.name}.{tag}")
    tmp_meta.write_text(json.dumps(
        {"entry": path.name, "env": _env_fields(toolchain, card)},
        sort_keys=True, indent=1))
    os.replace(tmp_meta, meta)
    with _lock:
        _built.add(path)


def load_library(path: Path,
                 build: Callable[[], None]) -> Tuple[ctypes.CDLL, bool]:
    """Load the entry at ``path``, calling ``build()`` (which stores it)
    when it is missing, and once more when it does not load; a second
    failure raises ``OSError``.  Returns the library and whether it was a
    hit: loaded without this process compiling it."""
    path = Path(path)
    if not path.exists():
        build()
    lib = open_library(path)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(path))
    with _lock:
        hit = path not in _built
    _bump(hit)
    return lib, hit


def _entries(root: Path) -> list:
    """The store's entries: each ``.so`` with a ``.json`` meta beside it
    (the other files of ``build/`` are not the store's)."""
    try:
        return [p for p in Path(root).glob("*.so")
                if p.with_suffix(_META_SUFFIX).exists()]
    except OSError:
        return []


def prune(root, capacity: int) -> int:
    """LRU-evict library entries beyond ``capacity``.  Returns the number
    evicted.  (``cache_capacity`` bounds the executables, as in JAX:
    :func:`prune_executables`; it does not size the libraries.)"""
    entries = _entries(Path(root))
    if len(entries) <= capacity:
        return 0

    def mtime(p):
        try:
            return p.stat().st_mtime
        except OSError:
            return 0.0

    entries.sort(key=mtime)
    evicted = 0
    for path in entries[:len(entries) - capacity]:
        _remove_entry(path)
        evicted += 1
    if evicted:
        hvd_logging.info(
            "compile_cache: evicted %d LRU entr%s (capacity %d)",
            evicted, "y" if evicted == 1 else "ies", capacity)
    return evicted


def entry_count(root: Optional[str] = None) -> int:
    """Number of library entries on disk (0 when the store is
    disabled)."""
    root = root or resolve_dir()
    if root is None:
        return 0
    return len(_entries(Path(root)))


def _capacity() -> int:
    from horovod_tpu_torch.runtime import state as rt_state

    return rt_state.global_state().config.cache_capacity \
        if rt_state.is_initialized() else 1024


# -- the AOT executable store -------------------------------------------------

_AOT_SUFFIX = ".pt2"
_UNSET = object()


def _aot_dir(root) -> Path:
    return Path(root) / "aot"


def _aot_entry(root, key: str) -> Path:
    return _aot_dir(root) / (key + _AOT_SUFFIX)


def _executables(root) -> list:
    """The store's AOT entries (not the temporary packages being compiled
    beside them, whose names start with a dot)."""
    try:
        return [p for p in _aot_dir(root).glob("*" + _AOT_SUFFIX)
                if not p.name.startswith(".")]
    except OSError:
        return []


def _remove_aot_entry(path: Path) -> None:
    path.unlink(missing_ok=True)
    path.with_suffix(_META_SUFFIX).unlink(missing_ok=True)


@functools.lru_cache(maxsize=None)
def _triton_version() -> Optional[str]:
    try:
        import triton
    except ImportError:
        return None
    return triton.__version__


def _args_device(args):
    """The first CUDA device among ``args``' tensors, else None."""
    import torch
    from torch.utils._pytree import tree_leaves

    for leaf in tree_leaves(list(args)):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return None


def export_key(graph_text: str, args=None, extras: Optional[dict] = None,
               device=None) -> str:
    """Content hash identifying one AOT executable (JAX's
    ``executable_key`` over the lowered text): the exported graph's text,
    the signature of the inputs it was exported for (the graph's text
    names no shape), the kernel library's digest (the graph calls the
    ``hvd_torch`` ops), the environment fields (torch, CUDA and, with
    ``device``, the card and Triton, which Inductor generates code for)
    and ``extras``.  Weight values are inputs, not part of the key."""
    payload = {
        "kernels": _kernel_digest(),
        "env": _env_fields(_host_compiler(), card=device is not None,
                           device=device),
        "triton": _triton_version() if device is not None else None,
        "extras": extras or {},
        "inputs": None if args is None else _batch_sig(list(args)),
        "module_sha": hashlib.sha256(
            graph_text.encode("utf-8", "replace")).hexdigest(),
    }
    blob = json.dumps(payload, sort_keys=True, default=_stable_repr)
    return hashlib.sha256(blob.encode()).hexdigest()


def _host_compiler() -> Optional[str]:
    """The C++ compiler AOTInductor builds and links a package's host code
    with: the ``g++`` on ``PATH``, as ``native/`` builds its library (the
    package links OpenMP, which a ``CXX`` pointing elsewhere may lack)."""
    return shutil.which("g++")


def _load_package(path):
    from torch._inductor import aoti_load_package

    return aoti_load_package(str(path))


def load_executable(key: str, root):
    """The AOTInductor package stored under ``key``, loaded, or ``None``
    on a miss.  A load touches the entry (LRU recency); an entry that does
    not load is removed with a warning, and ``None`` is returned (the
    caller compiles it again)."""
    path = _aot_entry(root, key)
    if not path.exists():
        return None
    try:
        compiled = _timed("load", _load_package, path)
    except Exception as e:  # noqa: BLE001 — any failure = compile again
        hvd_logging.warning(
            "compile_cache: could not load AOT entry %s (%s); recompiling",
            key[:12], e)
        _remove_aot_entry(path)
        return None
    os.utime(path, None)
    return compiled


def store_executable(key: str, compiled, root,
                     capacity: Optional[int] = None,
                     meta: Optional[dict] = None) -> bool:
    """Move ``compiled`` (the path of a package AOTInductor wrote in the
    store's ``aot/`` directory) into place under ``key`` by a rename, so a
    concurrent loader never sees half a file; write ``meta`` beside it the
    same way; then prune the least recently used entries beyond
    ``capacity``.  A failure is a warning and ``False``: the executable
    already loaded still runs, and the next start compiles again."""
    path = _aot_entry(root, key)
    try:
        os.replace(compiled, path)
        tmp = path.with_name(f".tmp.{key}.{os.getpid()}{_META_SUFFIX}")
        tmp.write_text(json.dumps({"entry": path.name, **(meta or {})},
                                  sort_keys=True, indent=1,
                                  default=_stable_repr))
        os.replace(tmp, path.with_suffix(_META_SUFFIX))
    except OSError as e:
        hvd_logging.warning(
            "compile_cache: could not store AOT entry %s (%s); the next "
            "start compiles it again", key[:12], e)
        Path(compiled).unlink(missing_ok=True)
        return False
    prune_executables(root, capacity)
    return True


def _mtime(p: Path) -> float:
    try:
        return p.stat().st_mtime
    except OSError:
        return 0.0


def prune_executables(root, capacity: Optional[int] = None) -> int:
    """LRU-evict AOT entries beyond ``capacity`` (default: the runtime
    config's ``cache_capacity``, JAX's ``prune``).  Returns the number
    evicted."""
    capacity = _capacity() if capacity is None else capacity
    entries = sorted(_executables(root), key=_mtime)
    evicted = entries[:max(len(entries) - capacity, 0)]
    for path in evicted:
        _remove_aot_entry(path)
    if evicted:
        hvd_logging.info(
            "compile_cache: evicted %d LRU AOT entr%s (capacity %d)",
            len(evicted), "y" if len(evicted) == 1 else "ies", capacity)
    return len(evicted)


def executable_count(root: Optional[str] = None) -> int:
    """Number of AOT entries on disk (0 when the store is disabled)."""
    root = root or resolve_dir()
    if root is None:
        return 0
    return len(_executables(root))


def _as_module(fn):
    """``fn`` as the module ``torch.export`` takes (a module as it is)."""
    import torch

    if isinstance(fn, torch.nn.Module):
        return fn

    class Fn(torch.nn.Module):
        def forward(self, *args):
            return fn(*args)

    return Fn()


def aot_compile(fn_or_module, args: Tuple[Any, ...],
                extras: Optional[dict] = None, directory: Any = _UNSET,
                capacity: Optional[int] = None):
    """Export ``fn_or_module(*args)`` and compile it through the AOT store.

    Returns ``(executable, cache_hit)``: a callable taking ``args``' shapes.
    Export (tracing, with fake tensors) always runs — its graph is the
    key (:func:`export_key`) — then the executable is loaded from
    ``<root>/aot/<key>.pt2`` (``cache_hit=True``) or compiled by
    ``torch._inductor.aoti_compile_and_package`` and stored for the next
    start.  ``directory`` defaults to the configured root; with the store
    disabled (or ``directory=None``) the package is compiled into this
    process's private directory every time, uncounted.  An export or a
    compile that fails raises: nothing runs eagerly instead.  Tensors the
    function reads that are not among ``args`` would be packaged as
    constants: pass weights as inputs (``torch.func.functional_call``)."""
    import torch

    root = resolve_dir() if directory is _UNSET else directory
    device = _args_device(args)
    with torch.no_grad():
        ep = _timed("export", torch.export.export, _as_module(fn_or_module),
                    tuple(args))
    key = export_key(str(ep.graph), args, extras, device)
    if root is not None:
        compiled = load_executable(key, root)
        if compiled is not None:
            _bump(True)
            return compiled, True
    home = _aot_dir(_private_store() if root is None else root)
    home.mkdir(parents=True, exist_ok=True)
    tmp = home / f".tmp.{key}.{os.getpid()}.{threading.get_ident()}" \
        f"{_AOT_SUFFIX}"
    try:
        cxx = _host_compiler()
        _timed("compile", torch._inductor.aoti_compile_and_package, ep,
               package_path=str(tmp),
               inductor_configs={"cpp.cxx": (cxx,)} if cxx else None)
        compiled = _timed("load", _load_package, tmp)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    if root is None:
        tmp.unlink()
        return compiled, False
    store_executable(key, tmp, root, capacity=capacity,
                     meta={"extras": extras or {},
                           "env": _env_fields(_host_compiler(),
                                              card=device is not None,
                                              device=device)})
    _bump(False)
    return compiled, False


# -- the in-memory layer -----------------------------------------------------

class ExecutableLRU:
    """Captured executables (:class:`CapturedGraph` and what a replay
    reads and writes), LRU-bounded by ``capacity`` (default: the runtime
    config's ``cache_capacity``, read when the cache is made), each
    :meth:`get` counted as a hit or a miss, here (``hits``/``misses``) and
    process-wide (JAX's step counts its in-memory LRU so)."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = _capacity() if capacity is None else int(capacity)
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key, valid: Optional[Callable[[Any], bool]] = None) -> Any:
        """The entry of ``key``, or None (a miss).  An entry that
        ``valid`` rejects (it was captured on tensors that are no longer
        the ones to use) is dropped, and the lookup is a miss."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None and (valid is None or valid(entry)):
                self._entries[key] = entry      # reinsert = most recent
            else:
                entry = None
            if entry is None:
                self.misses += 1
            else:
                self.hits += 1
        _count_memory(entry is not None)
        return entry

    def put(self, key, entry) -> None:
        with self._lock:
            self._entries.pop(key, None)
            self._entries[key] = entry
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        """Drop every entry (their graphs' memory pools go with the last
        reference)."""
        with self._lock:
            self._entries.clear()

    def values(self) -> list:
        with self._lock:
            return list(self._entries.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries


class CapturedGraph:
    """One call of a function captured as a ``torch.cuda.CUDAGraph``
    (:func:`capture`): the graph, what the call returned (tensors the
    graph writes at each replay), the kernel launches one replay runs
    (the wrappers' counts during the capture, which launched nothing) and
    the capture's seconds."""

    def __init__(self, graph, result, launches: dict, seconds: float):
        self.graph = graph
        self.result = result
        self.launches = launches
        self.seconds = seconds

    def replay(self) -> None:
        """Run the graph on the current stream, and count its kernels'
        launches as the wrappers count an eager launch."""
        from horovod_tpu_torch.ops import kernels as K

        self.graph.replay()
        K.add_launch_counts(self.launches)


def capture(fn: Callable[[], Any], stream) -> CapturedGraph:
    """``fn()`` captured as a CUDA graph on ``stream`` (which first waits
    for the current stream's work), in the thread-local capture mode: NCCL's
    watchdog thread queries its events while this thread captures, which
    the default global mode forbids.  ``fn``'s first-use work (allocating
    state, the kernels' host-side setup) must have run eagerly before.
    The wrappers' launch counts of the capture are taken out again (the
    kernels did not run) and become the graph's record, which each
    :meth:`CapturedGraph.replay` adds."""
    import torch

    from horovod_tpu_torch.ops import kernels as K

    stream.wait_stream(torch.cuda.current_stream(stream.device))
    graph = torch.cuda.CUDAGraph()
    before = K.launch_counts()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        result = fn()
    seconds = time.perf_counter() - t0
    after = K.launch_counts()
    launches = {k: n - before[k] for k, n in after.items()
                if n != before[k]}
    K.add_launch_counts({k: -n for k, n in launches.items()})
    return CapturedGraph(graph, result, launches, seconds)
