"""Continuous batcher: packs compatible requests into executables (a copy
of ``horovod_tpu/serve/batcher.py``).

The batcher is the serving plane's engine loop.  Each :meth:`step`
drains up to ``HOROVOD_SERVE_MAX_BATCH`` batch-compatible requests
(same :func:`~horovod_tpu_torch.serve.request.payload_signature`) from the
admission queue, leases them to a SERVING replica picked round-robin
from the pool, and feeds the observed service time back to the queue's
admission controller.  Run it inline (tests, seeded scenarios —
deterministic on a logical clock) or as a background feeder thread
(:meth:`start` / :meth:`stop`, the production shape).

:class:`ExecutableCache` is the hot-swap layer: batch sizes are bucketed
so a handful of padded executables cover every occupancy, each bucket
built once.  :meth:`ExecutableCache.from_exported` (JAX's ``from_jitted``)
compiles each bucket ahead of time through the compile cache's AOT store
(``runtime/compile_cache.aot_compile``), so a replica's next start loads
the executables instead of compiling them.  :meth:`ExecutableCache.
from_module` builds them over a ``torch.nn.Module`` in the process: a
bucket's first build runs the forward once at the padded size, and on a
card each bucket's executor is a CUDA graph of the forward, kept in the
compile cache's in-memory layer.

Fault site ``serve.feed`` fires at the top of every step; a ``hang``
there models a wedged queue feeder (docs/faults.md).
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.runtime.config import _env_int
from horovod_tpu_torch.serve.pool import ReplicaPool
from horovod_tpu_torch.serve.queue import AdmissionQueue
from horovod_tpu_torch.serve.request import InferenceResponse, payload_signature

DEFAULT_MAX_BATCH = 8
DEFAULT_BUCKET_SIZES = (1, 2, 4, 8, 16, 32)

_TEL_OCCUPANCY = telemetry.histogram(
    "hvd_serve_batch_occupancy", "requests packed per executed batch",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))


class ExecutableCache:
    """Executable hot-swap keyed by ``(model_id, signature, padded
    batch size)``.

    ``build(signature, padded_size) -> executor`` is invoked once per
    key (a ``build`` taking a third ``model_id`` argument receives it —
    the fleet shape, one executable set per tenant model); use
    :meth:`from_module` to build them over a model.  Short batches are
    padded up to the next bucket (by repeating the tail payload) and the
    results truncated, so the executable set stays small and every size
    hits a cached entry.  ``model_id=None`` keys the single-model plane —
    its entries never collide with a named tenant's.
    """

    def __init__(self, build: Callable[..., Callable],
                 bucket_sizes: Sequence[int] = DEFAULT_BUCKET_SIZES):
        self._build = build
        try:
            params = inspect.signature(build).parameters
            self._build_takes_model = len(params) >= 3 or any(
                p.kind == inspect.Parameter.VAR_POSITIONAL
                for p in params.values())
        except (TypeError, ValueError):    # builtins, C callables
            self._build_takes_model = False
        self.bucket_sizes = tuple(sorted(bucket_sizes))
        self._lock = threading.Lock()
        self._cache: Dict[Tuple[Optional[str], Tuple, int],
                          Callable] = {}
        #: the captured graphs of :meth:`from_module`'s executors on a
        #: card (None otherwise), the weights they were captured with, and
        #: the one stream they are all captured on (torch keeps a cuBLAS
        #: workspace, 32 MiB on Hopper, for every stream that ever ran a
        #: matmul)
        self.graphs = None
        self._graph_weights = None
        self._capture_stream = None
        self._graph_lock = threading.Lock()

    @classmethod
    def from_module(cls, model, example_batch: Callable[[Tuple, int], Any],
                    bucket_sizes: Sequence[int] = DEFAULT_BUCKET_SIZES
                    ) -> "ExecutableCache":
        """Executors over ``model``'s forward.  ``example_batch`` maps
        ``(signature, padded_size)`` to an input batch of that size; each
        bucket's build runs the forward on it once under
        ``torch.inference_mode()`` on the model's device (the counterpart
        of the JAX package's compile of the bucket).  An executor stacks
        the payloads, runs the forward —
        ``torch.func.functional_call(model, weights, ...)`` when given
        ``weights`` (a name → tensor dict of the model's parameters and
        buffers) — and returns one result per payload: the output's rows.

        On the CPU the executor runs the forward eagerly.  On a card it
        replays a CUDA graph of the forward under
        ``torch.inference_mode()``, captured when the bucket is built
        (the model's own weights) or at the first call with a weights
        dict: the payloads are copied into the graph's static input of
        the padded size and the output's rows are cloned out before the
        next replay.  The graphs live in the compile cache's in-memory
        layer (:attr:`graphs`, an :class:`~horovod_tpu_torch.runtime.
        compile_cache.ExecutableLRU` bounded by ``cache_capacity``),
        counted, one a ``(signature, padded)``, all of one set of weights:
        a call with other weights (a flip, ``serve/refresh.py``) drops
        every graph of the old weights, which frees them and the graphs'
        memory pools, and captures anew (a miss).  On a card an executor
        returns once the device has computed its results, so the pool
        stamps a response's latency at the result, not at its dispatch."""
        import torch

        device = next(iter(model.parameters()), torch.empty(0)).device
        on_card = device.type == "cuda"

        def forward(x, weights):
            return model(x) if weights is None else \
                torch.func.functional_call(model, weights, (x,))

        def stacked(payloads):
            x = torch.stack([torch.as_tensor(p) for p in payloads])
            return x.to(device, non_blocking=True)

        def build(signature: Tuple, padded: int) -> Callable:
            example = example_batch(signature, padded).to(device)
            if not on_card:
                with torch.inference_mode():
                    model(example)
                return executor
            # the bucket's graph with the model's own weights, captured
            # now (its warm-up forward is the build's)
            cache._graph(signature, padded, forward, example, None)

            def graph_executor(payloads: Sequence[Any],
                               weights=None) -> List[Any]:
                captured = cache._graph(signature, padded, forward, example,
                                        weights)
                return captured(stacked(payloads))

            return graph_executor

        def executor(payloads: Sequence[Any], weights=None) -> List[Any]:
            x = stacked(payloads)
            with torch.inference_mode():
                out = forward(x, weights)
            return _computed(out)

        cache = cls(build, bucket_sizes=bucket_sizes)
        if on_card:
            from horovod_tpu_torch.runtime import compile_cache

            cache.graphs = compile_cache.ExecutableLRU()
            cache._capture_stream = torch.cuda.Stream(device)
        return cache

    @classmethod
    def from_exported(cls, model, example_batch: Callable[[Tuple, int], Any],
                      bucket_sizes: Sequence[int] = DEFAULT_BUCKET_SIZES,
                      **aot_kwargs) -> "ExecutableCache":
        """Executors compiled ahead of time through the compile cache's AOT
        store (JAX's ``from_jitted``): each bucket's build exports
        ``torch.func.functional_call(model, weights, (x,))`` at the padded
        size of ``example_batch(signature, padded)`` and compiles it with
        AOTInductor, or loads the package a former process stored
        (``compile_cache.aot_compile``, ``extras`` naming the signature and
        the bucket; ``aot_kwargs`` pass on).  The weights, a name → tensor
        dict of the model's parameters and buffers, are inputs of the
        executable, as JAX's jitted forward takes its params: an entry
        holds no weights, and an executor called with ``weights=`` (a flip,
        ``serve/refresh.py``) runs the same executable on them.  The
        ``hvd_torch`` ops stay calls in the package (``flash_fwd`` on a
        card launches its kernel); Inductor generates the code around them.
        An executor stacks the payloads and returns one result per
        payload, the output's rows, once the device has computed them."""
        import torch

        from horovod_tpu_torch.runtime import compile_cache

        own = {**dict(model.named_parameters()),
               **dict(model.named_buffers())}
        device = next(iter(own.values()), torch.empty(0)).device

        def forward(x, weights):
            return torch.func.functional_call(model, weights, (x,))

        def build(signature: Tuple, padded: int) -> Callable:
            example = example_batch(signature, padded).to(device)
            compiled, _ = compile_cache.aot_compile(
                forward, (example, own),
                extras={"serve_signature": repr(signature),
                        "serve_batch": padded}, **aot_kwargs)

            def executor(payloads: Sequence[Any],
                         weights=None) -> List[Any]:
                x = torch.stack([torch.as_tensor(p) for p in payloads])
                given = own if weights is None else \
                    {name: weights[name] for name in own}
                with torch.inference_mode():
                    out = compiled(x.to(device, non_blocking=True), given)
                return _computed(out)

            return executor

        return cls(build, bucket_sizes=bucket_sizes)

    def _graph(self, signature: Tuple, padded: int, forward, example,
               weights) -> "_CapturedForward":
        """The bucket's graph for these weights, captured on a miss; a
        call with other weights than the graphs' drops them all first
        (:meth:`from_module`)."""
        with self._graph_lock:
            if weights is not self._graph_weights:
                self.graphs.clear()
                self._graph_weights = weights
            captured = self.graphs.get((signature, padded))
            if captured is None:
                captured = _CapturedForward(forward, example, weights,
                                            self._capture_stream)
                self.graphs.put((signature, padded), captured)
        return captured

    def padded_size(self, n: int) -> int:
        for b in self.bucket_sizes:
            if n <= b:
                return b
        return n

    def get(self, signature: Tuple, n: int,
            model_id: Optional[str] = None) -> Callable:
        key = (model_id, signature, self.padded_size(n))
        with self._lock:
            ex = self._cache.get(key)
        if ex is None:
            if self._build_takes_model and model_id is not None:
                built = self._build(signature, key[2], model_id)
            else:
                built = self._build(signature, key[2])
            with self._lock:
                ex = self._cache.setdefault(key, built)
        return ex

    def run(self, payloads: Sequence[Any],
            model_id: Optional[str] = None, **kwargs) -> List[Any]:
        """Replica-executor entry point: pad to the bucket, execute,
        truncate — shaped to plug straight into ``Replica(executor=)``
        (extra replica keywords like ``weights`` pass through to the
        built executor when it accepts them, and are dropped when it
        does not — a weight-less executable set stays valid)."""
        payloads = list(payloads)
        signature = payload_signature(payloads[0])
        padded = self.padded_size(len(payloads))
        ex = self.get(signature, len(payloads), model_id=model_id)
        full = payloads + [payloads[-1]] * (padded - len(payloads))
        if kwargs:
            try:
                accepts = any(
                    p.kind == inspect.Parameter.VAR_KEYWORD
                    or p.name in kwargs
                    for p in inspect.signature(ex).parameters.values())
            except (TypeError, ValueError):
                accepts = False
            if accepts:
                return list(ex(full, **kwargs))[:len(payloads)]
        return list(ex(full))[:len(payloads)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)


def _computed(out) -> List[Any]:
    """``out``'s rows once the device has computed them (an event on the
    current stream, so other threads' work is not waited for)."""
    import torch

    if out.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(out.device))
        done.synchronize()
    return list(out.unbind(0))


class _CapturedForward:
    """One bucket's forward captured as a CUDA graph with one set of
    weights (held here while the graph may read them): a static input of
    the padded size, the graph
    (:class:`~horovod_tpu_torch.runtime.compile_cache.CapturedGraph`, whose
    result is the output it writes), and a lock, since a replay and the
    copies around it must not interleave with another thread's.  The
    forward runs once eagerly on the capture's ``stream`` first (the
    stream's first-use work, which a capture forbids)."""

    def __init__(self, forward, example, weights, stream):
        import torch

        from horovod_tpu_torch.runtime import compile_cache

        self.weights = weights
        self.static = example.clone()
        stream.wait_stream(torch.cuda.current_stream(example.device))
        with torch.inference_mode():
            with torch.cuda.stream(stream):
                forward(self.static, weights)
            self.graph = compile_cache.capture(
                lambda: forward(self.static, weights), stream)
        torch.cuda.current_stream(example.device).wait_stream(stream)
        self._lock = threading.Lock()

    def __call__(self, x) -> List[Any]:
        with self._lock:
            self.static.copy_(x)
            self.graph.replay()
            return _computed(self.graph.result.clone())


class ContinuousBatcher:
    """Queue → replica engine loop (module docstring)."""

    def __init__(self, queue: AdmissionQueue, pool: ReplicaPool,
                 max_batch: Optional[int] = None,
                 on_response: Optional[Callable[[InferenceResponse],
                                                None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 poll_interval_s: float = 0.001):
        self._queue = queue
        self._pool = pool
        self.max_batch = max_batch if max_batch is not None \
            else _env_int("HOROVOD_SERVE_MAX_BATCH", DEFAULT_MAX_BATCH)
        self._on_response = on_response
        self._clock = clock
        self._poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def step(self) -> List[InferenceResponse]:
        """One engine iteration: pick a replica, lease a compatible
        batch, execute, feed service time back to admission.  Returns
        the responses (empty when idle, when no replica is SERVING, or
        when the replica died mid-batch — its lease re-enqueues)."""
        faults.inject("serve.feed")
        replica = self._pool.pick()
        if replica is None:
            return []
        batch = self._queue.take(self.max_batch)
        if not batch:
            return []
        _TEL_OCCUPANCY.observe(float(len(batch)))
        t0 = self._clock()
        responses = self._pool.execute(replica, batch)
        if responses:
            self._queue.note_service_time(max(self._clock() - t0, 0.0))
            if self._on_response is not None:
                for resp in responses:
                    self._on_response(resp)
        return responses

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self.step():
                # idle or drained — back off so the feeder doesn't spin
                self._stop.wait(self._poll_interval_s)

    def start(self) -> None:
        """Start the background feeder thread (production shape; tests
        and the seeded scenarios call :meth:`step` inline instead)."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="hvd-serve-batcher", daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
