"""The port's paged KV pool, paging ops and prefix cache against the JAX
package's (``mxnet_tpu/serve/kv_blocks.py``, ``prefix_cache.py`` and
``ops.nn.paged_kv_gather``/``paged_kv_scatter``).

The paging ops are pure copies, so they are held to the JAX ops bitwise
on the same pools, tables, rings and positions. The allocator and the
trie are host code copied from the JAX package; their invariants are the
JAX tests' (``tests/test_kv_blocks.py``, ``tests/test_prefix_cache.py``).
The paged and prefix ``Generator``s are held to the ring ``Generator`` and
to the JAX package's paged and prefix ``Generator``s by greedy tokens, on
the ``pallas`` and ``int8`` rungs (not against the JAX ``baseline`` rung,
whose compiler options the installed JAX refuses; the port's paged
``baseline`` rung is held to its ring run bit for bit in
``test_torch_stable.py``). The weights come from the JAX model through
``load_reference_params``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import numpy as mnp
from mxnet_tpu.models.llama import get_llama as jax_get_llama
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.serve import Generator as JaxGenerator
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_llama, load_reference_params
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops.hopper.decode_attention import natural_block
from mxnet_tpu_torch.serve import (Generator, PagedKVPool, PoolExhausted,
                                   PrefixCache, resolve_page_size)

_MODELS = {}


def _models(config="llama_tiny_test"):
    """(JAX model, port model with the JAX model's weights, vocab)."""
    if config not in _MODELS:
        mx.random.seed(0)
        net = jax_get_llama(config)
        net.initialize()
        params = {k: v.data().asnumpy()
                  for k, v in net.collect_params().items()}
        port = load_reference_params(get_llama(config, device="cpu"), params)
        _MODELS[config] = (net, port, params["embed.weight"].shape[0])
    return _MODELS[config]


def _pool(**kw):
    _, port, _ = _models()
    return PagedKVPool(port, **kw)


def _row(pool, slot):
    return [int(p) for p in pool.table()[slot] if p != 0]


# ---------------------------------------------------------------------------
# allocator invariants (tests/test_kv_blocks.py::TestAllocator)
# ---------------------------------------------------------------------------


def test_page_size_resolution(monkeypatch):
    assert natural_block() == 32
    assert resolve_page_size(16, 64) == 16
    assert resolve_page_size(None, 1024) == 32     # the kernel's tile
    assert resolve_page_size(None, 16) == 16       # clamped to max_seq
    monkeypatch.setenv("MXNET_SERVE_KV_PAGE_SIZE", "8")
    assert resolve_page_size(None, 64) == 8
    with pytest.raises(MXNetError, match="multiple of the KV page"):
        resolve_page_size(24, 64)


def test_assign_release_recycle():
    pool = _pool(num_slots=4, max_seq=64, page_size=16)
    assert pool.pages_per_slot == 4
    assert pool.pages_total == 4 * 4  # auto-sized: exhaustion-free
    assert pool.assign(0, 5) == 1
    assert pool.assign(1, 17) == 2
    assert pool.pages_used == 3
    tab = pool.table()
    assert tab[0, 0] != 0 and (tab[0, 1:] == 0).all()
    assert (tab[1, :2] != 0).all() and (tab[1, 2:] == 0).all()
    held = [p for row in tab for p in row if p != 0]
    assert len(set(held)) == len(held) and 0 not in held
    # release recycles LIFO: the next assign reuses the hot pages
    freed = set(tab[1][:2])
    assert pool.release(1) == 2
    assert pool.release(1) == 0  # idempotent
    assert pool.assign(2, 20) == 2
    assert set(pool.table()[2][:2]) == freed
    assert pool.high_water == 3
    with pytest.raises(MXNetError, match="already owns"):
        pool.assign(2, 10)
    with pytest.raises(MXNetError, match="exceeds max_seq"):
        pool.assign(3, 65)
    # the device table follows assign/release
    assert torch.equal(pool.table_nd(), torch.as_tensor(pool.table()))
    pool.release(0)
    assert torch.equal(pool.table_nd(), torch.as_tensor(pool.table()))


def test_exhaustion_is_503_and_atomic():
    # 4 usable pages for 2 slots of up to 4 pages each: oversubscribed
    pool = _pool(num_slots=2, max_seq=64, page_size=16, num_pages=5)
    pool.assign(0, 48)  # 3 pages
    with pytest.raises(PoolExhausted) as ei:
        pool.assign(1, 32)  # needs 2, only 1 free
    assert ei.value.status == 503
    assert ei.value.retry_after_ms is not None
    assert pool.pages_free == 1
    assert pool.exhausted_count == 1
    pool.release(0)
    assert pool.assign(1, 32) == 2


def test_int8_pool_interleave_and_bytes():
    _, port, _ = _models()
    pool = PagedKVPool(port, num_slots=2, max_seq=64, page_size=16,
                       quant="int8")
    flat = pool.flat()
    assert len(flat) == 4 * len(port._blocks)
    # [k, k_scale, v, v_scale] per layer, as KVCache.flat()
    assert [a.dtype for a in flat[:4]] == [torch.int8, torch.float32,
                                           torch.int8, torch.float32]
    assert flat[1].dim() == 3 and flat[0].device == torch.device("cpu")
    assert pool.nbytes() == sum(a.numel() * a.element_size() for a in flat)
    with pytest.raises(MXNetError, match="expected"):
        pool.update_from_flat(flat[:-1])


def test_refcounts_shared_assign_and_release():
    pool = _pool(num_slots=4, max_seq=64, page_size=16)
    pool.assign(0, 40)                       # 3 pages
    shared = _row(pool, 0)[:2]
    pool.assign_with_prefix(1, 40, shared)   # 2 shared + 1 fresh
    row1 = _row(pool, 1)
    assert row1[:2] == shared and row1[2] not in _row(pool, 0)
    assert pool.refcount(shared[0]) == 2 and pool.pages_shared == 2
    pool.release(0)
    assert [pool.refcount(p) for p in shared] == [1, 1]
    pool.release(1)
    assert pool.pages_used == 0
    # a trie adopting pages keeps them past their slot's release
    pool.assign(0, 20)
    pages = _row(pool, 0)
    pool.incref(pages)
    pool.release(0)
    assert pool.pages_used == 2
    pool.decref(pages)
    assert pool.pages_used == 0
    with pytest.raises(MXNetError, match="decref"):
        pool.decref(pages)
    with pytest.raises(MXNetError, match="not all live"):
        pool.assign_with_prefix(0, 40, (3,))
    # exhaustion with shared pages is atomic too
    small = _pool(num_slots=2, max_seq=64, page_size=16, num_pages=4)
    small.assign(0, 20)
    shared = _row(small, 0)
    with pytest.raises(PoolExhausted):
        small.assign_with_prefix(1, 64, shared)
    assert [small.refcount(p) for p in shared] == [1, 1]
    assert _row(small, 1) == [] and small.exhausted_count == 1


# ---------------------------------------------------------------------------
# the paging ops, bitwise against the JAX ops
# ---------------------------------------------------------------------------


def _paged_case(kind, rng):
    """(pool, table, ring, start_pos, length) for one case: f32 (P, KV,
    page, D) pools, int8 pools, and 3-D (P, KV, page) scale pools; tables
    with null entries and a dead all-null row."""
    p, kv, pg, d, b, n = 9, 2, 4, 8, 3, 3
    shape = (p, kv, pg) if kind == "scale" else (p, kv, pg, d)
    rshape = (b, kv, n * pg) if kind == "scale" else (b, kv, n * pg, d)
    if kind == "int8":
        pool = rng.randint(-127, 128, size=shape).astype(np.int8)
        ring = rng.randint(-127, 128, size=rshape).astype(np.int8)
    else:
        pool = rng.randn(*shape).astype(np.float32)
        ring = rng.randn(*rshape).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    start = np.array([5, 6, 2], np.int32)
    return pool, table, ring, start


@pytest.mark.parametrize("length", [1, 3, 8])
@pytest.mark.parametrize("kind", ["f32", "int8", "scale"])
def test_paged_ops_bitwise_equal_jax(kind, length):
    """Gather and scatter (lengths 1, 3 and 8 rows: a decode step, a
    prefill, a super-step running past the table and the ring's end) give
    the JAX ops' bytes; the scatter writes the pool in place and leaves
    page 0 zeroed."""
    rng = np.random.RandomState({"f32": 0, "int8": 1, "scale": 2}[kind])
    pool, table, ring, start = _paged_case(kind, rng)
    jring = jops.paged_kv_gather(mnp.array(pool), mnp.array(table)).asnumpy()
    tring = tops.paged_kv_gather(torch.from_numpy(pool),
                                 torch.from_numpy(table))
    assert tring.is_contiguous() and tring.dtype == torch.from_numpy(
        pool).dtype
    np.testing.assert_array_equal(tring.numpy(), jring)
    jout = jops.paged_kv_scatter(mnp.array(pool), mnp.array(table),
                                 mnp.array(ring), mnp.array(start),
                                 length).asnumpy()
    tpool = torch.from_numpy(pool.copy())
    ret = tops.paged_kv_scatter(tpool, torch.from_numpy(table),
                                torch.from_numpy(ring),
                                torch.from_numpy(start), length)
    assert ret is tpool
    np.testing.assert_array_equal(tpool.numpy(), jout)
    assert not tpool[0].any()


# ---------------------------------------------------------------------------
# the radix trie (tests/test_prefix_cache.py::TestTrie)
# ---------------------------------------------------------------------------


def test_trie_match_insert_full_pages_only():
    pool = _pool(num_slots=2, max_seq=64, page_size=16)
    trie = PrefixCache(pool, name="t_trie")
    toks = list(range(100, 140))             # 40 tokens
    pool.assign(0, len(toks))
    pages = _row(pool, 0)
    assert trie.insert(toks, pages) == 2     # 40 // 16 full pages
    assert [pool.refcount(p) for p in pages[:2]] == [2, 2]
    m, got = trie.match(toks)
    assert m == 32 and list(got) == pages[:2]
    # a page-aligned prompt matches one page short: >= 1 token prefills
    m, got = trie.match(toks[:32])
    assert m == 16 and len(got) == 1
    assert trie.match(toks[:16])[0] == 0
    assert trie.match([1, 2, 3])[0] == 0
    s = trie.stats()
    assert s["pages_held"] == 2 and s["hits"] == 2 and s["misses"] == 2


def test_trie_reclaim_lru_skips_live_and_excluded():
    pool = _pool(num_slots=2, max_seq=128, page_size=16)
    trie = PrefixCache(pool, name="t_reclaim")
    a, b = list(range(200, 232)), list(range(300, 332))
    pool.assign(0, 32)
    pa = _row(pool, 0)
    trie.insert(a, pa)
    pool.release(0)
    pool.assign(0, 32)
    pb = _row(pool, 0)
    trie.insert(b, pb)
    pool.release(0)
    trie.match(a)                            # touch a: b is now LRU
    # a live reference pins b's leaf, and an interior node is never
    # evicted from under its child: only a's chain (2 pages) frees
    pool.incref([pb[1]])
    assert trie.reclaim(4) == 2
    assert pool.refcount(pb[1]) == 2
    assert trie.stats()["evictions"] == 2
    assert trie.match(a)[0] == 0
    pool.decref([pb[1]])
    pool.assign(0, 32)
    pc = _row(pool, 0)
    trie.insert(list(range(400, 432)), pc)
    pool.release(0)
    assert trie.reclaim(8, exclude=set(pc)) == 2
    assert trie.pages_held == 2
    assert trie.clear() == 2 and pool.pages_used == 0


# ---------------------------------------------------------------------------
# paged and prefix Generators
# ---------------------------------------------------------------------------

GEN_KW = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(16,))


def _prompts(vocab, seed, lens=(7, 12)):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, vocab, size=n)] for n in lens]


def test_paged_step_logits_bitwise_equal_ring():
    """The paged step brackets the unchanged cache path with exact
    copies, so on the CPU its logits are the ring step's bit for bit —
    prefill and 16 decode steps, on the 12-layer config."""
    _, port, vocab = _models("llama_serve_12l_test")
    ring = Generator(port, **GEN_KW)
    paged = Generator(port, paged=True, page_size=16, **GEN_KW)
    prompts = _prompts(vocab, 4)
    toks, lens, bb = ring._pad_prompts(prompts)
    lr, cr = ring.prefill(toks, lens, ring._fresh_cache(bb))
    lp, cp = paged.prefill(toks, lens, paged._fresh_cache(bb))
    assert torch.equal(lr, lp)
    ids = torch.argmax(lr, -1).to(torch.int32).numpy()
    pos = lens.copy()
    for step in range(16):
        lr, cr = ring.decode_step(ids, pos, cr)
        lp, cp = paged.decode_step(ids, pos, cp)
        assert torch.equal(lr, lp), f"decode step {step} diverged"
        ids = torch.argmax(lr, -1).to(torch.int32).numpy()
        pos = pos + 1


@pytest.mark.parametrize("multistep", [False, True],
                         ids=["single", "multistep"])
@pytest.mark.parametrize("rung", ["pallas", "int8"])
def test_paged_generate_tokens_identical_to_ring_and_jax(rung, multistep):
    """Greedy tokens of the paged Generator (page 8, so rows span pages
    and a super-step's scatter runs past a row's last page) equal the
    ring Generator's and the JAX package's paged Generator's, single-step
    and multi-step (N = 4)."""
    net, port, vocab = _models()
    kw = dict(GEN_KW, decode_path=rung, paged=True, page_size=8)
    jg = JaxGenerator(net, name=f"tkv_{rung}", **kw)
    pg = Generator(port, multistep=multistep, decode_steps=4, **kw)
    ring = Generator(port, decode_path=rung, **GEN_KW)
    pg.warmup()
    prompts = _prompts(vocab, 5)
    want, _ = ring.generate(prompts, max_new_tokens=12)
    jout, _ = jg.generate(prompts, max_new_tokens=12)
    got, info = pg.generate(prompts, max_new_tokens=12)
    assert got == want == [[int(t) for t in o] for o in jout]
    assert info["decode_visits"] == (3 if multistep else 11)
    pg.assert_no_recompiles()
    assert pg.kv_cache_bytes() == pg._fresh_cache(2).nbytes()


def test_paged_flag_turns_paging_on(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_KV_PAGED", "1")
    _, port, _ = _models()
    gen = Generator(port, **GEN_KW)
    assert gen._paged and isinstance(gen._fresh_cache(2), PagedKVPool)
    assert gen._fresh_cache(2).page_size == 32
    out, _ = gen.generate([[5, 6, 7]], max_new_tokens=4)
    assert len(out[0]) == 4
    with pytest.raises(MXNetError, match="paged"):
        Generator(port, paged=False, prefix_cache=True, **GEN_KW)


PREFIX_KW = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(8, 16, 32),
                 page_size=8)


@pytest.mark.parametrize("multistep", [False, True],
                         ids=["single", "multistep"])
@pytest.mark.parametrize("rung", ["pallas", "int8"])
def test_prefix_cache_tokens_identical_to_off_and_jax(rung, multistep):
    """Prompts sharing a 20-token prefix: the first generate seeds the
    trie, the second matches two full pages a row and prefills only the
    tail; both give the cache-off tokens and the JAX prefix Generator's.
    After every request retired, the only live pages are the trie's."""
    net, port, _ = _models()
    prompts = [list(range(3, 23)) + [40 + i] for i in range(2)]
    off = Generator(port, decode_path=rung, **PREFIX_KW)
    want, _ = off.generate(prompts, max_new_tokens=6)
    jg = JaxGenerator(net, decode_path=rung, prefix_cache=True,
                      name=f"tpx_{rung}", **PREFIX_KW)
    jfirst, _ = jg.generate(prompts, max_new_tokens=6)
    jagain, _ = jg.generate(prompts, max_new_tokens=6)
    gen = Generator(port, decode_path=rung, prefix_cache=True,
                    multistep=multistep, decode_steps=4, **PREFIX_KW)
    gen.warmup()
    first, _ = gen.generate(prompts, max_new_tokens=6)
    again, _ = gen.generate(prompts, max_new_tokens=6)
    assert first == again == want
    assert [[int(t) for t in o] for o in jfirst] == want
    assert [[int(t) for t in o] for o in jagain] == want
    gen.assert_no_recompiles()
    st = gen.stats()
    assert st["prefix"][2]["hits"] == 2
    assert st["prefix"][2]["tokens_matched"] == 2 * 16
    assert st["pool"][2]["pages_owned"] == 0
    assert st["pool"][2]["pages_used"] == st["prefix"][2]["pages_held"]


def test_prefix_cache_eviction_pressure_keeps_tokens():
    """A zero-headroom pool (two live 4-page budgets and the null page):
    pages the trie keeps past the current match must be swept at
    admission instead of raising PoolExhausted, and the tokens do not
    move."""
    net, port, _ = _models()
    families = [list(range(3, 19)), list(range(50, 66)),
                list(range(80, 96))]
    prompts = [fam + [100 + 7 * i + j for j in range(3)]
               for i, fam in enumerate(families * 2)]
    off = Generator(port, **PREFIX_KW)
    on = Generator(port, prefix_cache=True, kv_pages=9, **PREFIX_KW)
    jg = JaxGenerator(net, decode_path="pallas", prefix_cache=True,
                      kv_pages=9, name="tpx_evict", **PREFIX_KW)
    for i in range(0, len(prompts), 2):
        pair = prompts[i:i + 2]
        want, _ = off.generate(pair, max_new_tokens=6)
        got, _ = on.generate(pair, max_new_tokens=6)
        jout, _ = jg.generate(pair, max_new_tokens=6)
        assert got == want == [[int(t) for t in o] for o in jout]
    st = on.stats()
    assert st["prefix"][2]["hits"] > 0
    assert st["prefix"][2]["evictions"] > 0
    # a pool too small for one batch still raises, and leaks nothing
    tiny = Generator(port, prefix_cache=True, kv_pages=3, **PREFIX_KW)
    with pytest.raises(PoolExhausted):
        tiny.generate(prompts[:2], max_new_tokens=6)
    assert tiny.stats()["pool"][2]["pages_used"] == 0
