"""The strict rung's kernel plans (``ops.hopper.stable_ops``), on the CPU.

S1's and S2's plans are pure Python over shapes: which instantiation or
route a call takes, and how its blocks cut the work. A CUDA kernel has no
CPU mode, so these tests hold the plans themselves: the pick follows the
shapes alone, S1's block map covers each output once, and S2's rows blocks
fit the card's shared memory at every shape the serving paths give them.
"""
import numpy as np
import pytest

from mxnet_tpu_torch.models.llama import _LLAMA_CONFIGS
from mxnet_tpu_torch.ops.hopper import stable_ops as st

SMEM_LIMIT = 232448  # dynamic shared memory a block may take (H100)


@pytest.mark.parametrize("sm_count", [1, 78, 114, 132])
def test_dense_plan_prefill_tile_above_decode_rows(sm_count):
    """Above DECODE_ROWS the plan takes the ring-fed prefill tile at any
    O and SM count, never the first (global-load) prefill tile; at or
    below it a decode tile (one warp row)."""
    for o in (1, 37, 1024, 4096, 14336, 128256):
        for m in (st.DECODE_ROWS + 1, 100, 256, 1000, 1024, 4096):
            assert st.dense_plan(m, o, sm_count) == st.PREFILL_TILE
        for m in (1, 2, 4, 5, 20, st.DECODE_ROWS):
            tile = st.dense_plan(m, o, sm_count)
            assert tile != st.GLOBAL_PREFILL_TILE
            assert st.DENSE_WARPS[tile][0] == 1
    assert st.PREFILL_TILE != st.GLOBAL_PREFILL_TILE
    assert len(st.DENSE_TILES) == len(st.DENSE_WARPS)


@pytest.mark.parametrize("tile", range(len(st.DENSE_TILES)))
def test_dense_block_map_covers_each_output_once(tile):
    """Every instantiation's grid and warp map cover each (m, o) of a
    ragged M x O exactly once (the outputs a warp stores are its tile's
    inside M x O)."""
    tm, to = st.DENSE_TILES[tile]
    for m, o in ((1, 1), (33, 37), (1000, 37), (257, 300), (64, 64)):
        seen = np.zeros((m, o), np.int64)
        gx, gy = st.dense_grid(tile, m, o)
        for bx in range(gx):
            for by in range(gy):
                for r0, c0 in st.dense_warp_tiles(tile, bx, by):
                    seen[r0:r0 + tm, c0:c0 + to] += 1
        assert (seen == 1).all(), (tile, m, o)


def _serving_shapes():
    for name, cfg in sorted(_LLAMA_CONFIGS.items()):
        h, kv = cfg["num_heads"], cfg["num_kv_heads"]
        d = cfg["units"] // h
        for s in (64, 128, 256, 512, 1024, 2048, 4096, 8192):
            for t in (2, 8, 37, 256):
                yield name, h, kv, t, s, d


def test_attention_rows_plan_fits_and_follows_shapes():
    """S2 takes the heads kernel at T = 1 and the rows kernel where its
    grid fills the card; the rows plan (tq, gb) depends on (H, KV, T, S, D) alone, carries at most
    32 rows of one KV head's heads and at most T times, and its shared
    memory fits a block at every Llama config's heads over rings of 64 to
    8192 positions."""
    assert st.attention_route(4, 32, 8, 1, 1024, 128, 132) == "heads"
    # Llama-3-8B's 4 x 256 prefill and the engine's (1, 256) chunk fill
    # the card with rows blocks; a T = 8 chunk of 4 rows would not
    assert st.attention_route(4, 32, 8, 256, 1024, 128, 132) == "rows"
    assert st.attention_route(1, 32, 8, 256, 1024, 128, 132) == "rows"
    assert st.attention_route(4, 32, 8, 8, 1024, 128, 132) == "heads"
    for name, h, kv, t, s, d in _serving_shapes():
        plan = st.attention_rows_plan(h, kv, t, s, d)
        assert plan is not None, (name, s)
        tq, gb = plan
        assert plan == st.attention_rows_plan(h, kv, t, s, d)
        assert 1 <= gb <= h // kv and 1 <= tq <= t and tq * gb <= 32
        smem = st.attention_rows_smem_bytes(tq * gb, s, d)
        assert smem <= SMEM_LIMIT, (name, t, s, smem)
    # Llama-3-8B's 4 x 256 prefill over a 1024 ring: 8 times x 4 heads
    assert st.attention_rows_plan(32, 8, 256, 1024, 128) == (8, 4)
    assert st.attention_rows_smem_bytes(32, 1024, 128) == 4 * (
        2 * 32 * 132 + 2 * 32 * 128 + 32 * 128 + 32 * 1024)
    # longer rings trade query times, then heads, for score rows
    assert st.attention_rows_plan(32, 8, 256, 8192, 128) == (1, 4)
    assert st.attention_rows_plan(64, 1, 8, 64, 64) == (1, 32)
    assert st.attention_rows_plan(8, 1, 4, 40000, 128) == (1, 1)
    assert st.attention_rows_plan(8, 1, 4, 60000, 128) is None
