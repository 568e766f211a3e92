"""Seeded fault plans and the ``inject()`` hook.

A copy of ``horovod_tpu/faults/plan.py``: its warnings go to the standard
``logging`` module, and the ``corrupt`` action walks its value in the JAX
package's leaf order (:mod:`~horovod_tpu_torch.utils.pytree`: a dict's
keys sorted) and perturbs a torch tensor leaf on its own device, in its own
dtype.

Grammar (``HOROVOD_FAULT_PLAN``, ``;``-separated clauses)::

    seed=SEED                      deterministic RNG seed for ?prob draws
    mode=sim                       crash raises WorkerCrash instead of
                                   os._exit (in-process chaos tests)
    SITE[@HIT][:ACTION[(ARG)]][xCOUNT][?PROB]

``SITE`` is a dotted site name (see package docstring for the
instrumented sites).  ``@HIT`` is the 1-based hit index at which the
fault first fires (default 1); ``xCOUNT`` fires it on that many
consecutive hits (``x*`` = every hit from ``@HIT`` on); ``?PROB``
makes each eligible hit fire with probability PROB, decided by an RNG
seeded from ``(seed, site, hit)`` so the outcome is a pure function of
the plan — independent of thread interleaving across sites.

Actions:

=================  ==========================================================
``crash[(code)]``  ``os._exit(code)`` (default 173), or raise
                   :class:`WorkerCrash` in ``sim`` mode — worker dies at
                   step k
``hang[(s)]``      block for ``s`` seconds (default 3600) — alive but
                   making no progress; interruptible via ``plan.cancel()``
``raise[(Exc)]``   raise the named exception (default ``RuntimeError``);
                   supported names: OSError, IOError, TimeoutError,
                   ConnectionRefusedError, ConnectionResetError,
                   RuntimeError, ValueError, CalledProcessError,
                   TimeoutExpired
``delay[(s)]``     sleep ``s`` seconds (default 1.0) then continue — the
                   slow-host fault
``value[(v)]``     return ``v`` from ``inject()`` — the call site defines
                   the semantics (e.g. a discovery flap)
``corrupt[(s)]``   return a deterministically perturbed copy of the value
                   passed to ``inject(site, value=...)`` — one element of
                   one array leaf gets ``+= s * (1 + |x|)`` (default
                   ``s=1.0``), with leaf and element chosen by an RNG
                   seeded from ``(seed, site, hit)``.  The silent-data-
                   corruption fault (docs/guardian.md); with no value
                   passed, returns ``s`` itself
=================  ==========================================================
"""

from __future__ import annotations

import logging
import math
import os
import random
import subprocess
import threading
import time
from typing import Any, List, Optional, Tuple

hvd_logging = logging.getLogger("horovod_tpu_torch.faults")

_DEFAULT_CRASH_CODE = 173   # distinguishable from generic exit 1

_EXCEPTIONS = {
    "OSError": OSError,
    "IOError": OSError,
    "TimeoutError": TimeoutError,
    "ConnectionRefusedError": ConnectionRefusedError,
    "ConnectionResetError": ConnectionResetError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
}


class WorkerCrash(BaseException):
    """Simulated process death (``mode=sim`` crash action).

    Derives from ``BaseException`` so ordinary ``except Exception``
    recovery code cannot accidentally absorb a "process death" — only a
    chaos harness that asks for it catches it, matching how a real
    ``os._exit`` is invisible to in-process handlers."""

    def __init__(self, site: str, hit: int, code: int = _DEFAULT_CRASH_CODE):
        super().__init__(f"injected crash at {site} (hit {hit}), "
                         f"exit code {code}")
        self.site = site
        self.hit = hit
        self.code = code


class FaultSpec:
    """One scheduled fault: fire ``action`` at ``site`` on hits
    ``[at, at + count)`` (``count=-1`` = forever), each eligible hit
    firing with probability ``prob``."""

    __slots__ = ("site", "action", "arg", "at", "count", "prob")

    def __init__(self, site: str, action: str = "raise",
                 arg: Any = None, at: int = 1, count: int = 1,
                 prob: float = 1.0):
        if action not in ("crash", "hang", "raise", "delay", "value",
                          "corrupt"):
            raise ValueError(f"unknown fault action {action!r}")
        if at < 1:
            raise ValueError(f"fault hit index must be >= 1, got {at}")
        self.site = site
        self.action = action
        self.arg = arg
        self.at = int(at)
        self.count = int(count)
        self.prob = float(prob)

    def covers(self, hit: int) -> bool:
        if hit < self.at:
            return False
        return self.count < 0 or hit < self.at + self.count

    def __repr__(self):
        return (f"FaultSpec({self.site}@{self.at}:{self.action}"
                f"({self.arg}) x{self.count} ?{self.prob})")


class FaultPlan:
    """A deterministic, seeded schedule of faults.

    ``sim=True`` turns the ``crash`` action into a raised
    :class:`WorkerCrash` instead of ``os._exit`` — the in-process chaos
    harness mode.  All counters are per-site hit counts; the plan keeps
    a ``fired`` audit log ``(site, hit, action)`` for tests and the
    bench ``--chaos`` probe."""

    def __init__(self, specs: Optional[List[FaultSpec]] = None,
                 seed: int = 0, sim: bool = False):
        self.seed = int(seed)
        self.sim = bool(sim)
        self._specs: List[FaultSpec] = list(specs or [])
        self._hits = {}
        self._fired: List[Tuple[str, int, str]] = []
        self._lock = threading.Lock()
        self._cancel = threading.Event()

    # -- construction -------------------------------------------------------

    def add(self, site: str, action: str = "raise", arg: Any = None,
            at: int = 1, count: int = 1, prob: float = 1.0) -> "FaultPlan":
        self._specs.append(FaultSpec(site, action, arg, at, count, prob))
        return self

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse the ``HOROVOD_FAULT_PLAN`` grammar (module docstring)."""
        plan = cls()
        for raw in text.split(";"):
            clause = raw.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                plan.seed = int(clause[5:])
                continue
            if clause.startswith("mode="):
                mode = clause[5:].strip().lower()
                if mode not in ("sim", "process"):
                    raise ValueError(f"fault plan mode must be sim or "
                                     f"process, got {mode!r}")
                plan.sim = mode == "sim"
                continue
            plan._specs.append(_parse_clause(clause))
        return plan

    # -- firing -------------------------------------------------------------

    @property
    def specs(self) -> List[FaultSpec]:
        return list(self._specs)

    @property
    def fired(self) -> List[Tuple[str, int, str]]:
        with self._lock:
            return list(self._fired)

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def cancel(self) -> None:
        """Unblock any in-progress ``hang``/``delay`` waits (teardown)."""
        self._cancel.set()

    def inject(self, site: str, value: Any = None) -> Any:
        """One hit at ``site``: fire every matching spec.  Returns the
        ``value`` action's arg or the ``corrupt`` action's perturbed
        copy of ``value`` (last one wins) or None."""
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            due = [s for s in self._specs
                   if s.site == site and s.covers(hit)]
            due = [s for s in due if self._drawn(s, site, hit)]
            for s in due:
                self._fired.append((site, hit, s.action))
        out = None
        for s in due:
            res = self._fire(s, site, hit, value)
            if s.action in ("value", "corrupt"):
                out = res
        return out

    def _drawn(self, spec: FaultSpec, site: str, hit: int) -> bool:
        if spec.prob >= 1.0:
            return True
        # seeded per (plan seed, site, hit): a pure function of the
        # plan, independent of cross-site call interleaving
        rng = random.Random(f"{self.seed}:{site}:{hit}")
        return rng.random() < spec.prob

    def _fire(self, spec: FaultSpec, site: str, hit: int,
              value: Any = None) -> Any:
        hvd_logging.warning("faults: firing %s at %s (hit %d)",
                            spec.action, site, hit)
        # telemetry is imported lazily: telemetry.export imports this
        # package for its chaos hook, and _fire only runs under an
        # active plan — never on the production no-op path
        from horovod_tpu_torch import telemetry

        telemetry.counter(
            "hvd_faults_injected_total",
            "chaos faults fired by the active plan").inc(
                site=site, action=spec.action)
        if spec.action == "crash":
            code = int(spec.arg) if spec.arg is not None \
                else _DEFAULT_CRASH_CODE
            if self.sim:
                raise WorkerCrash(site, hit, code)
            os._exit(code)
        if spec.action == "hang":
            seconds = float(spec.arg) if spec.arg is not None else 3600.0
            self._cancel.wait(seconds)
            return None
        if spec.action == "delay":
            seconds = float(spec.arg) if spec.arg is not None else 1.0
            # short sleeps use time.sleep (the cancel event costs ~50 us
            # per wait); long delays stay interruptible
            if seconds > 5.0:
                self._cancel.wait(seconds)
            else:
                time.sleep(seconds)
            return None
        if spec.action == "raise":
            raise _make_exception(spec.arg, site, hit)
        if spec.action == "corrupt":
            scale = float(spec.arg) if spec.arg is not None else 1.0
            return _corrupt_value(value, scale, self.seed, site, hit)
        return spec.arg       # "value"


def _corrupt_value(value: Any, scale: float, seed: int, site: str,
                   hit: int) -> Any:
    """Deterministic single-element perturbation of an array pytree.

    Leaf and flat index are drawn from an RNG seeded on
    ``(seed, site, hit)`` — a pure function of the plan, so two runs of
    the same plan corrupt the same element by the same amount.  The
    perturbation ``x += scale * (1 + |x|)`` moves the element whether or
    not it is near zero, and preserves the leaf's dtype.  The leaves are
    visited in the JAX package's order, so both packages pick the same
    element of the same tree; a torch tensor leaf comes back as a tensor
    of its dtype on its device (numpy leaves as numpy arrays), and the
    original is left untouched."""
    if value is None:
        return scale
    # lazy: only the corrupt action needs array machinery, and _fire
    # never runs on the production no-plan path
    import numpy as np
    import torch

    from horovod_tpu_torch.utils import pytree

    rng = random.Random(f"{seed}:{site}:{hit}:corrupt")
    leaves = pytree.leaves(value)
    eligible = [i for i, leaf in enumerate(leaves)
                if hasattr(leaf, "shape") and int(np.prod(leaf.shape)) > 0]
    if not eligible:
        return value
    li = eligible[rng.randrange(len(eligible))]
    leaf = leaves[li]
    if isinstance(leaf, torch.Tensor):
        # a device copy: no host round trip of the leaf, whatever its dtype
        out = leaf.detach().clone(memory_format=torch.contiguous_format)
        flat = out.view(-1)
        j = rng.randrange(flat.numel())
        x = float(flat[j])
        flat[j] = _rounded(x + scale * (1.0 + abs(x)), out.dtype)
    else:
        out = np.array(leaf)             # host copy, original untouched
        flat = out.reshape(-1)
        j = rng.randrange(flat.size)
        x = float(flat[j])
        flat[j] = np.asarray(x + scale * (1.0 + abs(x)), dtype=out.dtype)
    return pytree.map_leaves(value, lambda i, l: out if i == li else l)


#: (significand bits, least normal exponent in ``math.frexp``'s form) of
#: the half-width floats, which torch rounds from a Python float through
#: float32 (two roundings) where numpy rounds once
_HALF_FORMATS = {"torch.bfloat16": (8, -125), "torch.float16": (11, -13)}


def _rounded(v: float, dtype) -> float:
    """``v`` rounded to nearest-even in ``dtype`` when that is bf16 or
    fp16 (a value torch then stores exactly), else ``v``."""
    fmt = _HALF_FORMATS.get(str(dtype))
    if fmt is None or v == 0.0 or not math.isfinite(v):
        return v
    bits, emin = fmt
    e = max(math.frexp(v)[1], emin)
    return math.ldexp(round(math.ldexp(v, bits - e)), e - bits)


def _make_exception(name: Optional[str], site: str, hit: int) -> BaseException:
    msg = f"injected fault at {site} (hit {hit})"
    if name is None:
        return RuntimeError(msg)
    if name == "CalledProcessError":
        return subprocess.CalledProcessError(1, f"fault:{site}")
    if name == "TimeoutExpired":
        return subprocess.TimeoutExpired(f"fault:{site}", 1.0)
    try:
        return _EXCEPTIONS[name](msg)
    except KeyError:
        raise ValueError(f"unknown fault exception {name!r} (supported: "
                         f"{sorted(_EXCEPTIONS) + ['CalledProcessError', 'TimeoutExpired']})")


def _parse_clause(clause: str) -> FaultSpec:
    """``SITE[@HIT][:ACTION[(ARG)]][xCOUNT][?PROB]``"""
    work = clause
    prob = 1.0
    if "?" in work:
        work, _, p = work.rpartition("?")
        prob = float(p)
    count = 1
    action_part = None
    if ":" in work:
        work, _, action_part = work.partition(":")
        if "x" in action_part:
            # split the trailing xCOUNT, but not the x inside "(...)"
            base, _, tail = action_part.rpartition("x")
            if ")" not in tail and base:
                count = -1 if tail.strip() == "*" else int(tail)
                action_part = base
    at = 1
    if "@" in work:
        work, _, at_s = work.partition("@")
        at = int(at_s)
    site = work.strip()
    if not site:
        raise ValueError(f"fault clause has no site: {clause!r}")
    action, arg = "raise", None
    if action_part:
        action_part = action_part.strip()
        if "(" in action_part:
            action, _, rest = action_part.partition("(")
            arg = rest.rstrip(")").strip() or None
        else:
            action = action_part
    return FaultSpec(site, action, arg, at, count, prob)


# -- process-wide plan ------------------------------------------------------

_plan: Optional[FaultPlan] = None
_env_checked = False
_state_lock = threading.Lock()


def set_plan(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` as the process-wide active plan (None clears)."""
    global _plan, _env_checked
    with _state_lock:
        _plan = plan
        _env_checked = True    # an explicit plan overrides the env


def clear_plan() -> None:
    set_plan(None)


def active_plan() -> Optional[FaultPlan]:
    return _plan


def _plan_text(config=None) -> Optional[str]:
    """``HOROVOD_FAULT_PLAN``, resolved as the compile cache resolves its
    knobs: an explicit ``config``'s ``fault_plan``, else the initialized
    runtime's, else the environment's (before ``init()``)."""
    if config is None:
        from horovod_tpu_torch.runtime import state as rt_state

        if rt_state.is_initialized():
            config = rt_state.global_state().config
    if config is not None:
        return config.fault_plan
    return os.environ.get("HOROVOD_FAULT_PLAN")


def load_env_plan(force: bool = False, config=None) -> Optional[FaultPlan]:
    """Parse ``HOROVOD_FAULT_PLAN`` into the active plan (once; pass
    ``force=True`` to re-read after changing the env or the runtime's
    config); ``config`` is the runtime's ``Config`` while ``init()``
    runs."""
    global _plan, _env_checked
    with _state_lock:
        if _env_checked and not force:
            return _plan
        _env_checked = True
        text = _plan_text(config)
        if text:
            _plan = FaultPlan.parse(text)
            hvd_logging.warning(
                "faults: HOROVOD_FAULT_PLAN active — %d fault(s), seed %d%s",
                len(_plan.specs), _plan.seed,
                " (sim mode)" if _plan.sim else "")
        return _plan


def inject(site: str, value: Any = None) -> Any:
    """The chaos hook: one hit at ``site`` against the active plan.

    ``value`` is only consulted by the ``corrupt`` action, which returns
    a perturbed copy of it; other actions ignore it.

    No active plan → returns None after one global check (plus a
    one-time env parse on the first call in the process) — cheap enough
    for per-step and per-batch call sites."""
    if _plan is None:
        if _env_checked:
            return None
        if load_env_plan() is None:
            return None
    return _plan.inject(site, value)
