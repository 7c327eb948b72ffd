"""The strict rung's kernel plans (``ops.hopper.stable_ops``), on the CPU.

S1's and S2's plans are pure Python over shapes: which instantiation or
route a call takes, and how its blocks cut the work. A CUDA kernel has no
CPU mode, so these tests hold the plans themselves: the pick follows the
shapes alone, S1's block map covers each output once, S2's rows and decode
blocks and S3's staged blocks fit the card's shared memory at every shape
the serving paths give them, and the decode kernel's slices and S3's blocks
cover each position, column and row once.
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
    """S2 takes the decode kernel at T = 1 and the rows kernel where its
    grid fills the card; the rows plan (tq, gb) depends on (H, KV, T, S, D) alone, carries at most
    32 rows of one KV head's heads and at most T times, and its shared
    memory fits a block at every Llama config's heads over rings of 64 to
    8192 positions."""
    assert st.attention_route(4, 32, 8, 1, 1024, 128, 132) == "decode"
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


@pytest.mark.parametrize("m", [1, 4, 5, 1024, 4095])
@pytest.mark.parametrize("n", [4096, 4095, 30, 8192])
def test_norm_plan_fits_and_covers_each_row_once(m, n):
    """S3's staged plan: at most 8 rows a block (a block a row at decode's
    4 rows, 8 at a prefill's 1024 on 132 SMs), its shared memory within
    the block limit, and the blocks' rows (block i: rows i * rows up to M)
    cover every row once."""
    rows = st.norm_plan(m, n, 132)
    assert rows is not None and 1 <= rows <= 8
    assert rows == st.norm_plan(m, n, 132)
    assert st.norm_smem_bytes(rows, n) <= SMEM_LIMIT
    seen = np.zeros(m, np.int64)
    for b in range(-(-m // rows)):
        seen[b * rows:min(b * rows + rows, m)] += 1
    assert (seen == 1).all()
    assert st.norm_plan(4, 4096, 132) == 1
    assert st.norm_plan(1024, 4096, 132) == 8
    assert st.norm_smem_bytes(8, 4096) == 4 * 9 * 4096


def test_norm_plan_refuses_rows_too_long_to_stage():
    """Rows whose staged copy and gamma pass a block's shared memory have
    no staged plan (the warp-a-row kernel takes them); fewer rows a block
    where eight would not fit."""
    assert st.norm_plan(4, 28928, 132) == 1
    assert st.norm_plan(4, 28944, 132) is None
    assert st.norm_plan(4, 29056, 132) is None
    assert st.norm_plan(1024, 16384, 132) == 2
    assert st.norm_smem_bytes(2, 16384) <= SMEM_LIMIT
    assert st.norm_smem_bytes(3, 16384) > SMEM_LIMIT


@pytest.mark.parametrize("d", [30, 128, 256])
def test_decode_column_slices_cover_each_column_once(d):
    """Pass 3 of the decode kernel: the cluster's blocks take column slices
    that start at multiples of 4 and cover 0..D-1 exactly once, for every
    cluster size."""
    for cluster in range(1, 9):
        seen = np.zeros(d, np.int64)
        for rank in range(cluster):
            d0, d1 = st.decode_column_slice(d, cluster, rank)
            assert (d0 % 4 == 0 or d0 == d) and d0 <= d1 <= d
            seen[d0:d1] += 1
        assert (seen == 1).all(), (d, cluster)


def test_decode_position_slices_cover_each_live_position_once():
    """Pass 1 of the decode kernel: the blocks' position slices start at
    multiples of 4 and cover 0..n-1 exactly once, from n = 1 to a full
    1024-position ring, for every cluster size."""
    for cluster in range(1, 9):
        for n in list(range(1, 70)) + [266, 267, 1000, 1023, 1024]:
            seen = np.zeros(n, np.int64)
            for rank in range(cluster):
                j0, j1 = st.decode_position_slice(n, cluster, rank)
                assert j0 % 4 == 0 or j0 == n
                assert j0 <= j1 <= n
                seen[j0:j1] += 1
            assert (seen == 1).all(), (n, cluster)


def test_attention_decode_plan_fits_and_follows_shapes():
    """S2's decode plan: a cluster of at most 8 blocks carrying at most 8
    query heads of one KV head; its shared memory fits a block at every
    Llama config's heads over rings up to 1024 positions; the plan
    refuses where no cluster size fits (the heads kernel then takes T =
    1); Llama-3-8B's decode (B = 4, KV = 8) takes clusters of 4, a block
    an SM of 132."""
    for name, cfg in sorted(_LLAMA_CONFIGS.items()):
        h, kv = cfg["num_heads"], cfg["num_kv_heads"]
        d = cfg["units"] // h
        for s in (64, 128, 256, 512, 1024):
            for b in (1, 4, 32):
                plan = st.attention_decode_plan(b, h, kv, 1, s, d, 132)
                assert plan is not None, (name, s)
                cluster, gb = plan
                assert 1 <= cluster <= 8 and 1 <= gb <= min(h // kv, 8)
                assert plan == st.attention_decode_plan(b, h, kv, 1, s, d,
                                                        132)
                assert st.attention_decode_smem_bytes(
                    s, d, cluster, gb) <= SMEM_LIMIT
                assert st.attention_route(b, h, kv, 1, s, d, 132) == "decode"
    assert st.attention_decode_plan(4, 32, 8, 1, 1024, 128, 132) == (4, 4)
    assert st.attention_decode_plan(1, 32, 8, 1, 1024, 128, 132) == (8, 4)
    assert st.attention_decode_plan(32, 32, 8, 1, 1024, 128, 132) == (1, 4)
    assert st.attention_decode_smem_bytes(1024, 128, 8, 4) == 4 * (
        64 * 132 + 2 * 4 * 1028 + 4 * 128)
    # a short ring: at most a block a 32 positions
    assert st.attention_decode_plan(4, 32, 8, 1, 64, 128, 132) == (2, 4)
    # more heads than a cluster carries: 8 a cluster
    assert st.attention_decode_plan(1, 64, 1, 1, 256, 64, 132)[1] == 8
    # rings too long for any cluster size: no plan, the heads kernel
    assert st.attention_decode_plan(4, 32, 8, 1, 4096, 128, 132) == (4, 4)
    assert st.attention_decode_plan(4, 32, 8, 1, 8192, 128, 132) is None
    assert st.attention_route(4, 32, 8, 1, 8192, 128, 132) == "heads"
    assert st.attention_decode_plan(4, 8, 1, 1, 4096, 256, 132) is None


def test_attention_route_keeps_t_above_one():
    """The decode kernel takes T = 1 only: above it the route is the rows
    or heads kernel as the rows plan's grid decides."""
    for b, h, kv, t, s, d in ((4, 32, 8, 256, 1024, 128),
                              (1, 32, 8, 256, 1024, 128),
                              (4, 32, 8, 8, 1024, 128), (2, 6, 6, 3, 70, 30),
                              (2, 8, 2, 5, 333, 256)):
        assert st.attention_route(b, h, kv, t, s, d, 132) in ("rows",
                                                              "heads")
