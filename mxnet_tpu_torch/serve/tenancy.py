"""Multi-tenant serving: N named models per process (the port's
counterpart of ``mxnet_tpu/serve/tenancy.py``).

:class:`ModelRegistry` hosts several named models side by side, each
behind its own :class:`~.scheduler.ContinuousEngine` — so each tenant
gets a private ``PagedKVPool``, prefix trie and captured graphs, and
requests route by name through :meth:`submit` with the full admission
surface (priority classes, deadlines → 504, queue caps/sheds → 503,
idempotency keys) applied *by the tenant's own engine*, not
re-implemented here.

Budget semantics: at most ``MXNET_SERVE_MAX_MODELS`` tenants stay
resident. Loading past the budget LRU-evicts the coldest tenant —
preferring idle ones (no live slots, empty queue); a busy tenant is
only evicted when every resident tenant is busy. Eviction closes the
tenant's engine (503s its in-flight work and drops its pool and graphs)
but **keeps its factory**, so a later ``load()``/``submit()`` for that
name reloads it.

The JAX package's reload is warm from its persistent compile cache
(``compile_cache.enable()`` before the build) when
``MXNET_COMPILE_CACHE_DIR`` is set. The port has no persistent compile
cache yet, so there is no counterpart of that call: a reloaded tenant
pays its factory (the model build) plus its engine's ``warmup()`` —
on a GPU the CUDA-graph captures of a multi-step engine. Each load's
seconds are kept in :meth:`ModelRegistry.load_seconds`.

Lock discipline: the registry lock only guards the name → tenant map
and LRU bookkeeping. Engine builds, warmups, and closes — all blocking —
happen *outside* it, serialized per tenant by a loading event so two
threads racing ``load()`` on one name build once and the loser waits on
the event, not the lock.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref

from .engine import ServeError
from .scheduler import ContinuousEngine

__all__ = ["ModelRegistry", "registry_stats"]

# live registries, for the process-wide registry_stats() aggregate
# (profiler.export pulls it); weak so a retired registry never pins
_registries: "weakref.WeakSet" = weakref.WeakSet()


def registry_stats():
    """``{registry_name: summary}`` over every live ModelRegistry
    (pulled by ``profiler.export.snapshot()`` under ``tenancy.*``)."""
    return {r.name: r.summary() for r in list(_registries)}


class _Tenant:
    __slots__ = ("name", "factory", "engine_kwargs", "engine", "ready",
                 "last_used", "loads", "load_s")

    def __init__(self, name, factory, engine_kwargs):
        self.name = name
        self.factory = factory
        self.engine_kwargs = dict(engine_kwargs)
        self.engine = None
        self.ready = threading.Event()  # set once engine is live (or load failed)
        self.last_used = 0
        self.loads = 0
        self.load_s = []  # wall seconds of each build + warmup


class ModelRegistry:
    """Named-model host: ``load()`` builds/warms a tenant engine,
    ``submit(model=...)`` routes, cold tenants LRU-evict past the
    ``max_models`` budget.

    Parameters
    ----------
    max_models : resident-tenant budget (``MXNET_SERVE_MAX_MODELS``).
    name : registry label (tenant engines are named
        ``<name>.<tenant>``).
    engine_defaults : keyword defaults forwarded to every tenant's
        :class:`~.scheduler.ContinuousEngine` (``max_seq=``,
        ``num_slots=``, ``prefix_cache=``, ...); per-tenant ``load()``
        kwargs override them.
    """

    def __init__(self, max_models=None, name="registry",
                 **engine_defaults):
        from .. import config

        if max_models is None:
            max_models = int(config.get("MXNET_SERVE_MAX_MODELS"))
        self.max_models = int(max_models)
        if self.max_models < 1:
            raise ServeError("max_models must be >= 1")
        self.name = name
        self.engine_defaults = dict(engine_defaults)
        self._tenants = {}
        self._lock = threading.Lock()
        self._clock = itertools.count(1)
        self.evictions = 0
        self.loads = 0
        self._closed = False
        _registries.add(self)

    # -- loading -------------------------------------------------------------
    def load(self, name, model=None, factory=None, **engine_kwargs):
        """Make tenant ``name`` resident and return its engine.

        First call must supply ``model`` (a model on its device) or
        ``factory`` (zero-arg callable building one — kept for evicted-
        tenant reload, so prefer it for anything evictable). Later calls
        may omit both: a resident tenant is returned as-is (LRU-
        touched); an evicted one rebuilds from its stored factory. The
        build + warmup runs outside the registry lock; with the
        persistent compile cache enabled the warmup replays the bucket
        lattice from disk instead of compiling."""
        if factory is None and model is not None:
            factory = lambda m=model: m  # noqa: E731
        wait_for = None
        build_me = None
        with self._lock:
            if self._closed:
                raise ServeError(f"registry {self.name!r} is closed")
            t = self._tenants.get(name)
            if t is None:
                if factory is None:
                    raise ServeError(
                        f"unknown model {name!r}: first load() needs "
                        f"model= or factory=")
                t = _Tenant(name, factory, {**self.engine_defaults,
                                            **engine_kwargs})
                self._tenants[name] = t
            elif factory is not None:
                t.factory = factory
                if engine_kwargs:
                    t.engine_kwargs.update(engine_kwargs)
            t.last_used = next(self._clock)
            if t.engine is not None:
                return t.engine
            if t.ready.is_set() or t.loads == 0:
                # evicted (or brand new): this thread builds
                t.ready.clear()
                t.loads += 1
                self.loads += 1
                build_me = t
            else:
                wait_for = t  # another thread is mid-build
        if wait_for is not None:
            wait_for.ready.wait()
            if wait_for.engine is None:
                raise ServeError(
                    f"model {name!r} failed to load (concurrent load "
                    f"raised); retry load()")
            return wait_for.engine
        return self._build(build_me)

    def _build(self, t):
        victims = self._pick_victims(exclude=t.name)
        for v in victims:
            self._close_engine(v)
        engine = None
        t0 = time.perf_counter()
        try:
            engine = ContinuousEngine(
                t.factory(), name=f"{self.name}.{t.name}",
                **t.engine_kwargs)
            engine.start()  # warms up (graph captures) + scheduler
        except BaseException:
            if engine is not None:
                engine.close()
            with self._lock:
                self._tenants.pop(t.name, None)
            t.ready.set()
            raise
        t.load_s.append(time.perf_counter() - t0)
        t.engine = engine
        t.ready.set()
        return engine

    # -- eviction ------------------------------------------------------------
    def _pick_victims(self, exclude=None):
        """Detach enough LRU tenants (idle-first) to fit one more
        resident engine under the budget. Runs its map surgery under the
        lock; the blocking engine.close() happens at the caller, outside
        it."""
        out = []
        with self._lock:
            while True:
                resident = [t for t in self._tenants.values()
                            if t.engine is not None and t.name != exclude]
                if len(resident) < self.max_models:
                    break
                idle = [t for t in resident if t.engine._idle()]
                pool = idle or resident
                victim = min(pool, key=lambda t: t.last_used)
                out.append(victim.engine)
                victim.engine = None
                self.evictions += 1
        return out

    def _close_engine(self, engine):
        engine.close()

    def evict(self, name):
        """Explicitly evict tenant ``name`` (keeps its factory for
        reload). Returns True if an engine was actually closed."""
        with self._lock:
            t = self._tenants.get(name)
            engine = t.engine if t is not None else None
            if t is not None:
                t.engine = None
                if engine is not None:
                    self.evictions += 1
        if engine is None:
            return False
        self._close_engine(engine)
        return True

    # -- routing -------------------------------------------------------------
    def submit(self, model, prompt, **kwargs):
        """Route one generation request to tenant ``model``; all
        :meth:`~.scheduler.ContinuousEngine.submit` semantics pass
        through (``priority=``, ``deadline_ms=``, ``key=``, ...). An
        evicted tenant with a stored factory transparently reloads
        (blocking this caller for the build and warmup) — an unknown
        name is a
        :class:`ServeError`."""
        engine = self.load(model)
        return engine.submit(prompt, **kwargs)

    def get(self, name):
        """The tenant's live engine, or None (unknown/evicted). Does not
        touch LRU order."""
        with self._lock:
            t = self._tenants.get(name)
            return t.engine if t is not None else None

    def resident(self):
        with self._lock:
            return sorted(n for n, t in self._tenants.items()
                          if t.engine is not None)

    # -- readout / lifecycle -------------------------------------------------
    def summary(self):
        with self._lock:
            tenants = dict(self._tenants)
        return {"max_models": self.max_models,
                "resident": sum(1 for t in tenants.values()
                                if t.engine is not None),
                "known": len(tenants),
                "loads": self.loads,
                "evictions": self.evictions,
                "kv_cache_bytes": {
                    n: t.engine.pool.nbytes()
                    for n, t in tenants.items() if t.engine is not None}}

    def load_seconds(self):
        """``{tenant: [wall seconds of each load]}``: factory, engine
        build and ``warmup()``; a reload is every entry after the
        first."""
        with self._lock:
            return {n: list(t.load_s) for n, t in self._tenants.items()}

    def stats(self):
        out = self.summary()
        with self._lock:
            engines = {n: t.engine for n, t in self._tenants.items()
                       if t.engine is not None}
        out["models"] = {n: e.stats() for n, e in engines.items()}
        return out

    def close(self, timeout=5.0):
        with self._lock:
            self._closed = True
            engines = [t.engine for t in self._tenants.values()
                       if t.engine is not None]
            for t in self._tenants.values():
                t.engine = None
        for e in engines:
            e.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
