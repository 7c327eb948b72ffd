"""Deterministic, seedable fault injection (the port's own copy of
``mxnet_tpu/resilience/faults.py``).

A *fault plan* names injection **sites** and, per rule, decides
deterministically — by hit index or by a seeded RNG — when that site
throws a transient error, sleeps, raises a fatal error, or simulates
worker death. The port's sites are the serving stack's,
``serve:execute`` (``InferenceSession.run``), ``serve:queue``
(``DynamicBatcher.submit``) and ``serve:decode`` (each decode visit of
``ContinuousEngine``), and ``trainer:sharded_step``
(``parallel.ShardedTrainer.step``). Every site calls :func:`fault_point`, so a
process that never installs a plan pays one global load and an ``is
None`` test per site. (The JAX package also pokes a ``_FAULTS`` slot into
its dispatch, compile and collective modules; the port has none of those
modules.)

Plan format (programmatic dicts or the ``MXNET_FAULT_PLAN`` env var as
JSON, or ``@/path/to/plan.json``)::

    {"seed": 7, "rules": [
        {"site": "serve:decode",  "kind": "transient", "at": [0, 1]},
        {"site": "serve:execute", "kind": "fatal", "times": 1},
        {"site": "serve:queue",   "kind": "delay", "seconds": 0.2,
         "prob": 0.1}
    ]}

Rule matching: ``site`` must equal the instrumented site name (or
``"*"``). Exactly one trigger per rule: ``at`` (list of 0-based hit
indices for that rule), ``times`` (fire on the first N hits), or ``prob``
(per-hit probability from the plan-seeded RNG — deterministic for a fixed
seed and hit sequence). Kinds, as in the JAX package:

``transient``
    raises :class:`TransientFaultError`.
``fatal``
    raises :class:`InjectedFaultError`.
``delay``
    sleeps ``seconds`` (default 0.05).
``die``
    raises :class:`SimulatedWorkerDeath` (a ``BaseException``: ordinary
    ``except Exception`` recovery code cannot swallow it).
``nan``, ``torn``, ``preempt``, ``replica_delay``, ``param_corrupt``
    do not raise: :meth:`FaultPlan.check` returns a marker (``"nan"`` or
    ``{"kind": ...}``) that a corruption-capable call site acts on; the
    port's sites ignore it (``replica_delay`` also sleeps).
``chip_loss``
    raises :class:`ChipLostError` (carries ``.replica`` and ``.device``).

Per-replica rules carry a ``"replica"`` field and only *hit* when the
site's ``info`` dict carries no ``"replica"`` key or carries the same
value.
"""
from __future__ import annotations

import json
import threading
import time

from ..base import MXNetError
from ..profiler import core as _prof
from ..profiler import recorder as _recorder
from . import counters as _counters

# The port's instrumented sites (documented; fault_point accepts any name
# so new sites need no registry change):
KNOWN_SITES = (
    "serve:execute",        # serve.engine.InferenceSession.run, before the
                            # block executes (a prefill chunk or a decode
                            # step of the continuous engine)
    "serve:queue",          # serve.batcher.DynamicBatcher.submit, before
                            # admission — the error surfaces synchronously
                            # on the submitter; a 'delay' models a slow
                            # admission stall
    "serve:decode",         # serve.scheduler.ContinuousEngine, once per
                            # decode visit (a step or a super-step) — fails
                            # the requests decoding in it
    "trainer:sharded_step", # parallel.ShardedTrainer.step, before the step
                            # runs
)


class TransientFaultError(MXNetError):
    """Injected error a retry layer would classify as retryable."""


class InjectedFaultError(MXNetError):
    """Injected error classified fatal (never retried)."""


class ChipLostError(MXNetError):
    """Injected dead-device analog: the device group ``replica`` dropped
    out. ``device`` optionally addresses it by mesh coordinate — a flat
    device index (int) or ``{"axis": ..., "index": ...}``. (The JAX
    package's elastic layer consumes it; the port has none yet.)"""

    def __init__(self, msg, replica=0, device=None):
        super().__init__(msg)
        self.replica = int(replica)
        self.device = device


class SimulatedWorkerDeath(BaseException):
    """Simulated whole-worker crash (SIGKILL analog, testable in-process).

    Deliberately a ``BaseException``: the framework's defensive ``except
    Exception`` blocks must not be able to 'survive' a worker death.
    """


class FaultPlan:
    """A parsed, installed-once fault plan. Thread-safe; deterministic for
    a fixed seed and per-site hit order."""

    def __init__(self, spec):
        if isinstance(spec, FaultPlan):
            spec = spec.spec
        if isinstance(spec, str):
            spec = _parse_spec_str(spec)
        if not isinstance(spec, dict) or "rules" not in spec:
            raise MXNetError(
                "fault plan must be a dict with a 'rules' list "
                "(or JSON / @file via MXNET_FAULT_PLAN)")
        self.spec = spec
        self.seed = int(spec.get("seed", 0))
        self._lock = threading.Lock()
        self._rules = []
        import random as _random

        for i, r in enumerate(spec["rules"]):
            site = r.get("site")
            kind = r.get("kind", "transient")
            if not site:
                raise MXNetError(f"fault rule {i} missing 'site'")
            if kind not in ("transient", "fatal", "delay", "die", "nan",
                            "chip_loss", "replica_delay", "param_corrupt",
                            "torn", "preempt"):
                raise MXNetError(f"fault rule {i}: unknown kind {kind!r}")
            triggers = [t for t in ("at", "times", "prob") if t in r]
            if len(triggers) != 1:
                # a typoed trigger key would otherwise parse into a rule
                # that silently never fires — a test built on it would
                # pass while injecting nothing
                raise MXNetError(
                    f"fault rule {i} ({site}): exactly one trigger of "
                    f"'at'/'times'/'prob' required, got {triggers or r}")
            device = r.get("device")
            if device is not None:
                if kind != "chip_loss":
                    raise MXNetError(
                        f"fault rule {i} ({site}): 'device' is only valid "
                        f"on chip_loss rules, not {kind!r}")
                if isinstance(device, dict):
                    if not isinstance(device.get("axis"), str) \
                            or "index" not in device:
                        raise MXNetError(
                            f"fault rule {i} ({site}): coordinate device "
                            "must be {'axis': <name>, 'index': <int>}, "
                            f"got {device!r}")
                    device = {"axis": device["axis"],
                              "index": int(device["index"])}
                else:
                    device = int(device)
            self._rules.append({
                "site": site,
                "kind": kind,
                "at": set(r["at"]) if "at" in r else None,
                "times": int(r["times"]) if "times" in r else None,
                "prob": float(r["prob"]) if "prob" in r else None,
                "seconds": float(r.get("seconds", 0.05)),
                "replica": int(r["replica"]) if "replica" in r else None,
                "device": device,
                "message": r.get("message"),
                # per-rule RNG: independent deterministic streams, immune
                # to other rules' draw counts
                "rng": _random.Random(self.seed * 1000003 + i),
                "hits": 0,       # how often the site matched this rule
                "fired": 0,      # how often it actually injected
            })
        # lock-free pre-filter: a hot site with no rule for it costs one
        # frozenset lookup, not a lock + rule scan per dispatch
        self._sites = frozenset(r["site"] for r in self._rules)
        self._match_all = "*" in self._sites

    def stats(self):
        """Per-rule ``{site, kind, hits, fired}`` — tests assert on this."""
        with self._lock:
            return [{"site": r["site"], "kind": r["kind"],
                     "hits": r["hits"], "fired": r["fired"]}
                    for r in self._rules]

    def fired_total(self):
        with self._lock:
            return sum(r["fired"] for r in self._rules)

    def check(self, site, info=None):
        """Evaluate every matching rule for one hit of ``site``; raises or
        sleeps per the first rule that fires. Non-raising kinds return a
        marker instead: ``"nan"`` tells a corruption-capable call site to
        poison its payload (all other callers ignore the return value)."""
        if not self._match_all and site not in self._sites:
            return
        action = None
        with self._lock:
            for r in self._rules:
                if r["site"] != site and r["site"] != "*":
                    continue
                if r["replica"] is not None and isinstance(info, dict) \
                        and "replica" in info \
                        and int(info["replica"]) != r["replica"]:
                    # replica-targeted rule at a per-replica site: other
                    # replicas' visits don't hit (so `at` indices count
                    # the TARGET replica's visits, deterministically)
                    continue
                idx = r["hits"]
                r["hits"] += 1
                fire = False
                if r["at"] is not None:
                    fire = idx in r["at"]
                elif r["times"] is not None:
                    fire = r["fired"] < r["times"]
                elif r["prob"] is not None:
                    fire = r["rng"].random() < r["prob"]
                if fire and action is None:
                    r["fired"] += 1
                    action = r
        if action is None:
            return
        kind = action["kind"]
        msg = action["message"] or (
            f"injected {kind} fault at {site} "
            f"(plan seed {self.seed})")
        _counters.incr("resilience.faults_injected")
        # the failing SITE lands in the flight-recorder ring: a later
        # escalation dump (breaker-open, watchdog) names what fired here
        _recorder.note("fault", site, {"kind": kind})
        if _prof.ENABLED:
            _prof.record_instant(f"resilience::fault({site})", "resilience",
                                 args={"kind": kind})
        if kind == "delay":
            time.sleep(action["seconds"])
            return
        if kind == "nan":
            return "nan"
        if kind == "torn":
            # the checkpoint writer lands deliberately truncated bytes at
            # the final name instead of the atomic tmp+rename sequence
            return {"kind": "torn"}
        if kind == "preempt":
            # the preemption guard treats this as a delivered SIGTERM
            return {"kind": "preempt"}
        if kind == "replica_delay":
            # the replica filter above already scoped this hit to the
            # target replica (or the site carries no replica info)
            time.sleep(action["seconds"])
            return {"kind": "replica_delay",
                    "replica": action["replica"] or 0,
                    "seconds": action["seconds"]}
        if kind == "param_corrupt":
            return {"kind": "param_corrupt",
                    "replica": action["replica"] or 0}
        if kind == "chip_loss":
            where = (f"device {action['device']}"
                     if action["device"] is not None
                     else f"device group {action['replica'] or 0}")
            raise ChipLostError(
                action["message"] or
                f"injected chip loss at {site}: {where} dropped off the "
                f"mesh (plan seed {self.seed})",
                replica=action["replica"] or 0,
                device=action["device"])
        if kind == "transient":
            raise TransientFaultError(msg)
        if kind == "die":
            raise SimulatedWorkerDeath(msg)
        raise InjectedFaultError(msg)


# -- installation -----------------------------------------------------------

_active: FaultPlan | None = None
_env_checked = False
_install_lock = threading.Lock()

def _parse_spec_str(s):
    s = s.strip()
    if s.startswith("@"):
        with open(s[1:]) as f:
            s = f.read()
    try:
        return json.loads(s)
    except ValueError as e:
        raise MXNetError(f"MXNET_FAULT_PLAN is not valid JSON: {e}") from None


def install_plan(spec) -> FaultPlan:
    """Install ``spec`` (dict / JSON string / ``@file`` / FaultPlan) as THE
    process-wide fault plan, replacing any previous one."""
    global _active
    plan = spec if isinstance(spec, FaultPlan) else FaultPlan(spec)
    with _install_lock:
        _active = plan
    return plan


def clear_plan():
    """Remove the active fault plan (all sites return to zero-cost)."""
    global _active, _env_checked
    with _install_lock:
        _active = None
        _env_checked = True  # explicit clear also disables env re-install


def get_plan() -> FaultPlan | None:
    """The active plan; installs ``MXNET_FAULT_PLAN`` from the env on the
    first call if nothing was installed programmatically."""
    global _env_checked
    if _active is None and not _env_checked:
        with _install_lock:
            _env_checked = True
        from .. import config

        raw = config.get("MXNET_FAULT_PLAN")
        if raw:
            install_plan(raw)
    return _active


def fault_point(site, info=None):
    """Evaluate ``site`` against the active plan (every port site calls
    this). Forwards :meth:`FaultPlan.check`'s marker return."""
    plan = get_plan()
    if plan is not None:
        return plan.check(site, info)
    return None
