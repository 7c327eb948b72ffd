"""The port's multi-tenant registry (``serve.ModelRegistry``,
``registry_stats``) against the JAX package's on the same calls.

Two tenants behind ``max_models=1``: load the first, serve, load the
second (evicting the first), serve it, then serve the first again (a
transparent reload through its factory). The greedy tokens of every
request, the registry's summary (loads, evictions, residency, the
tenants' KV pool bytes) and its export gauges equal the JAX registry's,
on the ``pallas`` and ``int8`` rungs, single- and multi-step. Each
tenant's engine is a ``ContinuousEngine`` with the prefix cache on; the
port's weights come from the JAX models through
``load_reference_params``.
"""
import threading

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models.llama import get_llama as jax_get_llama
from mxnet_tpu.profiler import export as jexport
from mxnet_tpu.serve import ModelRegistry as JaxRegistry
from mxnet_tpu.serve import tenancy as jtenancy
from mxnet_tpu_torch.models import get_llama, load_reference_params
from mxnet_tpu_torch.profiler import export as texport
from mxnet_tpu_torch.serve import ModelRegistry, ServeError
from mxnet_tpu_torch.serve import tenancy as ttenancy

ENG_KW = dict(max_seq=64, num_slots=2, page_size=8, prefill_chunk=16,
              prefix_cache=True)
WAIT = 120

_MODELS = {}


def _models(seed):
    """(JAX tiny llama, port copy, vocab) built from ``seed``."""
    if seed not in _MODELS:
        mx.random.seed(seed)
        net = jax_get_llama("llama_tiny_test")
        net.initialize()
        params = {k: v.data().asnumpy()
                  for k, v in net.collect_params().items()}
        port = load_reference_params(
            get_llama("llama_tiny_test", device="cpu"), params)
        _MODELS[seed] = (net, port, params["embed.weight"].shape[0])
    return _MODELS[seed]


def _prompts(vocab, seed, lens=(6, 13)):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, vocab, size=n)] for n in lens]


def _serve(reg, name, prompts, budget=7):
    futs = [reg.submit(name, p, max_new_tokens=budget) for p in prompts]
    return [f.result(timeout=WAIT)["tokens"] for f in futs]


def _script(reg, side, vocab):
    """The sequence both registries run; returns what is compared."""
    pa, pb = _prompts(vocab, 1), _prompts(vocab, 2)
    a, b = _models(0)[side], _models(1)[side]
    reg.load("a", factory=lambda: a)
    rows = [reg.resident(), _serve(reg, "a", pa)]
    reg.load("b", factory=lambda: b)
    rows += [reg.resident(), reg.get("a") is None, _serve(reg, "b", pb)]
    rows += [_serve(reg, "a", pa), reg.resident()]       # reload of a
    summ = reg.summary()
    rows += [summ, reg.evict("a"), reg.evict("a"), reg.resident()]
    with pytest.raises(ServeError if side else Exception,
                       match="unknown model"):
        reg.submit("nope", pa[0])
    return rows


@pytest.mark.parametrize("rung,multistep", [("pallas", False),
                                            ("int8", True)])
def test_registry_sequence_equals_jax(rung, multistep):
    kw = dict(ENG_KW, decode_path=rung, multistep=multistep,
              decode_steps=4)
    vocab = _models(0)[2]
    _models(1)
    res = []
    for side, cls in ((0, JaxRegistry), (1, ModelRegistry)):
        with cls(max_models=1, name=f"ten_{rung}", **kw) as reg:
            res.append(_script(reg, side, vocab))
            if side:
                loads = reg.load_seconds()
                assert len(loads["a"]) == 2 and len(loads["b"]) == 1
                assert all(s > 0 for s in loads["a"] + loads["b"])
    assert res[0] == res[1]
    summ = res[1][7]
    assert summ["loads"] == 3 and summ["evictions"] == 2
    assert summ["resident"] == 1 and summ["known"] == 2
    # the reload serves the first load's tokens
    assert res[1][1] == res[1][5]


def test_registry_stats_and_export_gauges_match():
    """``registry_stats()`` and the ``tenancy.<name>.*`` export gauges
    carry the same values on both sides while a tenant is resident."""
    vocab = _models(0)[2]
    res = []
    for side, cls, mod, exp in ((0, JaxRegistry, jtenancy, jexport),
                                (1, ModelRegistry, ttenancy, texport)):
        with cls(max_models=2, name="ten_stats", decode_path="pallas",
                 **ENG_KW) as reg:
            reg.load("a", model=_models(0)[side])
            _serve(reg, "a", _prompts(vocab, 3)[:1], budget=3)
            snap = exp.snapshot()
            res.append((mod.registry_stats()["ten_stats"],
                        {k: v for k, v in snap.items()
                         if k.startswith("tenancy.ten_stats.")},
                        sorted(reg.stats()["models"])))
    assert res[0] == res[1]
    assert res[1][1]["tenancy.ten_stats.resident"] == 1


def test_concurrent_loads_build_once():
    """Two threads racing ``load()`` on one evicted name build it once;
    the loser waits on the tenant's event and gets the same engine."""
    _, port, _ = _models(0)
    builds = []

    def factory():
        builds.append(1)
        return port

    with ModelRegistry(max_models=1, name="ten_race", decode_path="pallas",
                       **ENG_KW) as reg:
        got = []
        ths = [threading.Thread(target=lambda: got.append(
            reg.load("a", factory=factory))) for _ in range(2)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(WAIT)
        assert len(builds) == 1 and got[0] is got[1]
        with pytest.raises(ServeError, match="max_models"):
            ModelRegistry(max_models=0)
    with pytest.raises(ServeError, match="closed"):
        reg.load("a")
