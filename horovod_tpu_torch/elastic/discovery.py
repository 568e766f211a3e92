"""Host discovery for elastic training (a copy of
``horovod_tpu/elastic/discovery.py``).

Reference: ``horovod/runner/elastic/discovery.py`` — ``HostDiscovery``
interface, ``HostDiscoveryScript`` (user script printing ``host:slots``
lines, re-run every second), ``FixedHosts`` (the built-in test fake), and
``HostManager`` which diffs discoveries, applies the exclusion rules and
keeps a stable host ordering for rank assignment.

Robustness changes over the reference (docs/faults.md):

* a failing discovery script **retains the last-good host set** instead
  of propagating into (and killing) the driver's discovery loop, with
  in-pass retries under the unified :class:`RetryPolicy`;
* worker-failure exclusion is a **quarantine with exponential-cooldown
  decay and probationary readmission** (:class:`HostQuarantine`) instead
  of a permanent blacklist: a flapping host stops churning generations
  (each relapse doubles its cooldown) but a genuinely recovered host
  rejoins without operator action.  The permanent :meth:`HostManager.
  blacklist` remains for explicit operator blacklisting;
* **starvation escape**: when a discovery pass finds hosts but every
  one of them is excluded, the earliest-eligible quarantined host is
  readmitted on probation instead of reporting an empty cluster — an
  all-flapping fleet must degrade to "keep trying the least-bad host",
  never to a discovery loop that stalls forever.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.utils import logging as hvd_logging

# quarantine/readmit transitions as events (docs/metrics.md) — today's
# log lines, scrapeable: a flapping host shows as a climbing
# `quarantined` count with matching `probation` readmissions
_TEL_QUARANTINE = telemetry.counter(
    "hvd_quarantine_events_total",
    "host quarantine state transitions (event=quarantined|probation|"
    "cleared)")


class HostUpdateResult:
    """Bitmask of what changed in a discovery pass (reference enum)."""

    no_update = 0
    removed = 1
    added = 2
    mixed = removed | added


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        """Return ``{hostname: slots}`` for every currently-usable host."""
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Execute the user's discovery script; stdout lines are
    ``hostname:slots`` (or bare hostnames with ``default_slots``).

    A script failure (non-zero exit, timeout, unparsable output) is
    retried under ``retry`` (env-default :class:`RetryPolicy`, capped at
    2 in-pass attempts — the discovery loop itself re-runs every
    second) and then **logged and absorbed**: the last successfully
    discovered host set is returned, so one flaky ``kubectl``/ssh call
    cannot take down the discovery loop or make the driver believe the
    cluster vanished."""

    def __init__(self, discovery_script: str, default_slots: int = 1,
                 retry=None):
        from horovod_tpu_torch.runtime.retry import RetryPolicy

        self._script = discovery_script
        self._default_slots = default_slots
        self._retry = retry if retry is not None else RetryPolicy(
            max_attempts=2, base_s=0.2, max_s=1.0, deadline_s=30.0,
            retry_on=(subprocess.CalledProcessError,
                      subprocess.TimeoutExpired, OSError),
            name="discovery-script")
        self._last_good: Optional[Dict[str, int]] = None
        self._consecutive_failures = 0

    @property
    def consecutive_failures(self) -> int:
        return self._consecutive_failures

    def _run_script(self) -> Dict[str, int]:
        faults.inject("discovery.script")
        out = subprocess.check_output(
            self._script, shell=True, timeout=60).decode()
        hosts: Dict[str, int] = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                name, _, slots = line.rpartition(":")
                hosts[name] = int(slots)
            else:
                hosts[line] = self._default_slots
        return hosts

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        try:
            hosts = self._retry.call(self._run_script)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                OSError, ValueError) as e:
            self._consecutive_failures += 1
            if self._last_good is not None:
                hvd_logging.warning(
                    "elastic: discovery script failed (%d consecutive: "
                    "%s: %s) — retaining last-good host set (%d host(s))",
                    self._consecutive_failures, type(e).__name__, e,
                    len(self._last_good))
                return dict(self._last_good)
            hvd_logging.warning(
                "elastic: discovery script failed (%d consecutive: %s: "
                "%s) and no prior result exists — reporting no hosts",
                self._consecutive_failures, type(e).__name__, e)
            return {}
        self._consecutive_failures = 0
        self._last_good = dict(hosts)
        return hosts


class FixedHosts(HostDiscovery):
    """Static (but settable) host set — the reference's test fake, also
    used for ``-H``-style elastic runs."""

    def __init__(self, available_hosts: Optional[Dict[str, int]] = None):
        self._hosts = dict(available_hosts or {})

    def set(self, available_hosts: Dict[str, int]) -> None:
        self._hosts = dict(available_hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


_QUARANTINED = "quarantined"
_PROBATION = "probation"


class HostQuarantine:
    """Per-host failure tracking with exponential-cooldown quarantine
    and probationary readmission.

    Failure ``n`` excludes the host for ``min(base_s * 2**(n-1),
    max_s)`` seconds.  After the cooldown the host is readmitted **on
    probation**: a relapse within ``probation_s`` re-quarantines it with
    the doubled cooldown (the failure count is retained), while
    surviving probation clears its record entirely — the decay that
    lets a repaired host return to full standing without operator
    action.

    Knobs: ``HOROVOD_QUARANTINE_BASE_S`` (30), ``HOROVOD_QUARANTINE_
    MAX_S`` (600), ``HOROVOD_QUARANTINE_PROBATION_S`` (120);
    ``HOROVOD_QUARANTINE_DISABLE=1`` restores the reference's permanent
    exclusion (every failure quarantines forever).  ``clock`` is
    injectable for deterministic tests."""

    def __init__(self, base_s: Optional[float] = None,
                 max_s: Optional[float] = None,
                 probation_s: Optional[float] = None,
                 disabled: Optional[bool] = None,
                 clock: Callable[[], float] = time.monotonic):
        env = os.environ.get
        self.base_s = float(base_s if base_s is not None
                            else env("HOROVOD_QUARANTINE_BASE_S", 30.0))
        self.max_s = float(max_s if max_s is not None
                           else env("HOROVOD_QUARANTINE_MAX_S", 600.0))
        self.probation_s = float(
            probation_s if probation_s is not None
            else env("HOROVOD_QUARANTINE_PROBATION_S", 120.0))
        self.disabled = bool(disabled if disabled is not None
                             else env("HOROVOD_QUARANTINE_DISABLE", "")
                             in ("1", "true", "yes", "on"))
        self._clock = clock
        # host -> {"failures": n, "state": ..., "until": t}
        self._hosts: Dict[str, dict] = {}

    def record_failure(self, host: str) -> float:
        """One failure incident; returns the cooldown applied (``inf``
        when quarantine decay is disabled)."""
        now = self._clock()
        rec = self._hosts.setdefault(
            host, {"failures": 0, "state": _QUARANTINED, "until": now})
        rec["failures"] += 1
        if self.disabled:
            cooldown = float("inf")
        else:
            cooldown = min(self.base_s * (2.0 ** (rec["failures"] - 1)),
                           self.max_s)
        rec["state"] = _QUARANTINED
        rec["until"] = now + cooldown
        _TEL_QUARANTINE.inc(event="quarantined")
        return cooldown

    def is_excluded(self, host: str) -> bool:
        """Whether ``host`` is currently held out of assignment; lazily
        advances the quarantined → probation → cleared transitions."""
        rec = self._hosts.get(host)
        if rec is None:
            return False
        now = self._clock()
        if rec["state"] == _QUARANTINED:
            if now < rec["until"]:
                return True
            rec["state"] = _PROBATION
            rec["until"] = now + self.probation_s
            _TEL_QUARANTINE.inc(event="probation")
            hvd_logging.info(
                "elastic: quarantine cooldown for host %s expired — "
                "readmitting on probation (%.0fs, %d prior failure(s))",
                host, self.probation_s, rec["failures"])
            return False
        # probation: available; survival past the window clears the record
        if now >= rec["until"]:
            del self._hosts[host]
            _TEL_QUARANTINE.inc(event="cleared")
            hvd_logging.info(
                "elastic: host %s survived probation — record cleared",
                host)
        return False

    def status(self, host: str) -> Optional[str]:
        rec = self._hosts.get(host)
        return None if rec is None else rec["state"]

    def force_probation(self, host: str) -> bool:
        """Readmit a quarantined host before its cooldown expires —
        the anti-starvation escape hatch (:meth:`HostManager.
        update_available_hosts`): the failure count is retained, so a
        relapse still gets the doubled cooldown.  Returns False when
        the host has no quarantine record to lift."""
        rec = self._hosts.get(host)
        if rec is None or rec["state"] != _QUARANTINED:
            return False
        rec["state"] = _PROBATION
        rec["until"] = self._clock() + self.probation_s
        _TEL_QUARANTINE.inc(event="probation")
        return True

    def failures(self, host: str) -> int:
        rec = self._hosts.get(host)
        return 0 if rec is None else rec["failures"]

    def remaining_s(self, host: str) -> float:
        """Seconds of cooldown left (0 when not quarantined)."""
        rec = self._hosts.get(host)
        if rec is None or rec["state"] != _QUARANTINED:
            return 0.0
        return max(rec["until"] - self._clock(), 0.0)


class HostManager:
    """Tracks the discovered host set, the exclusion rules (permanent
    blacklist + decaying quarantine) and a stable assignment order
    (reference ``HostManager``): surviving hosts keep their position,
    new hosts append — the property that lets surviving workers keep
    their ranks across resets."""

    def __init__(self, discovery: HostDiscovery,
                 quarantine: Optional[HostQuarantine] = None):
        self._discovery = discovery
        self._lock = threading.Lock()
        self._available: Dict[str, int] = {}
        self._order: List[str] = []
        self._blacklist: set = set()
        self._quarantine = quarantine if quarantine is not None \
            else HostQuarantine()

    def update_available_hosts(self) -> int:
        """Run one discovery pass; returns a :class:`HostUpdateResult`
        bitmask describing the delta.  Quarantine expiry is applied
        here, so a readmitted host surfaces as an ``added`` delta on
        the pass after its cooldown ends."""
        found = self._discovery.find_available_hosts_and_slots()
        with self._lock:
            usable = {h: s for h, s in found.items()
                      if h not in self._blacklist
                      and not self._quarantine.is_excluded(h)}
            if not usable and found and not self._quarantine.disabled:
                # starvation escape: every discovered host is excluded
                # (quarantine ∪ blacklist), so without intervention the
                # discovery loop would report an empty cluster until a
                # cooldown happens to expire — potentially forever with
                # flapping hosts re-doubling their cooldowns.  Readmit
                # the earliest-eligible quarantined host on probation
                # (failure count retained); permanently-blacklisted
                # hosts stay out, and HOROVOD_QUARANTINE_DISABLE=1
                # keeps the reference's exclude-forever behavior.
                cands = [h for h in found
                         if h not in self._blacklist
                         and self._quarantine.status(h) == _QUARANTINED]
                if cands:
                    pick = min(cands, key=lambda h: (
                        self._quarantine.remaining_s(h), h))
                    waived = self._quarantine.remaining_s(pick)
                    self._quarantine.force_probation(pick)
                    usable[pick] = found[pick]
                    hvd_logging.warning(
                        "elastic: every discovered host is excluded "
                        "(quarantine/blacklist) — readmitting host %s "
                        "early on probation (%.0fs of cooldown waived, "
                        "%d prior failure(s)) to avoid discovery "
                        "starvation", pick, waived,
                        self._quarantine.failures(pick))
            found = usable
            prev = self._available
            res = HostUpdateResult.no_update
            if any(h not in found or found[h] < prev[h] for h in prev):
                res |= HostUpdateResult.removed
            if any(h not in prev or found[h] > prev[h] for h in found):
                res |= HostUpdateResult.added
            self._available = found
            self._order = [h for h in self._order if h in found] + \
                          [h for h in found if h not in self._order]
            return res

    @property
    def current_hosts(self) -> Dict[str, int]:
        with self._lock:
            return {h: self._available[h] for h in self._order}

    @property
    def assignment_order(self) -> List[str]:
        with self._lock:
            return list(self._order)

    @property
    def host_quarantine(self) -> HostQuarantine:
        return self._quarantine

    def blacklist(self, host: str) -> bool:
        """PERMANENTLY exclude a host from all future assignments — the
        explicit operator action (and the reference's only behavior).
        Returns True if newly added."""
        with self._lock:
            if host in self._blacklist:
                return False
            hvd_logging.warning("elastic: blacklisting host %s "
                                "(permanent)", host)
            self._blacklist.add(host)
            self._drop_locked(host)
            return True

    def quarantine(self, host: str) -> float:
        """Exclude a failing host for an exponentially-growing cooldown
        (the failure-exit path).  Returns the cooldown seconds."""
        with self._lock:
            cooldown = self._quarantine.record_failure(host)
            self._drop_locked(host)
        hvd_logging.warning(
            "elastic: quarantining host %s for %.0fs (failure #%d; "
            "probationary readmission after cooldown)",
            host, cooldown, self._quarantine.failures(host))
        return cooldown

    def _drop_locked(self, host: str) -> None:
        self._available.pop(host, None)
        if host in self._order:
            self._order.remove(host)

    def is_blacklisted(self, host: str) -> bool:
        """Currently excluded from assignment — permanently blacklisted
        OR inside a quarantine cooldown.  (The driver's sibling-exit
        suppression and state-carrier checks need "excluded now", which
        both causes satisfy.)"""
        with self._lock:
            return host in self._blacklist \
                or self._quarantine.is_excluded(host)

    def is_quarantined(self, host: str) -> bool:
        with self._lock:
            return self._quarantine.is_excluded(host)

    @property
    def available_slots(self) -> int:
        with self._lock:
            return sum(self._available.values())
