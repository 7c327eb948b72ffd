"""The port's decode-attention module against the JAX package's.

``decode_attention_torch`` (the plain PyTorch version of the CUDA kernel)
is held against the JAX fused-einsum ``_xla_decode`` and against the Pallas
kernel itself, run in interpret mode on the CPU, on the same numpy inputs.
Both compute the same f32 function and differ only in the order of sums:
atol 2e-6 / rtol 2e-5, the tolerance the JAX package holds its own kernel
to its fallback with (tests/test_decode_paths.py).

``decode_attention_split_torch``, the plain mirror of the kernel's split
of a row across blocks and its in-order merge, is held to the same two at
the same tolerance, at split counts from 1 to past the ring's tiles, and
``split_plan`` (pure Python) is tested here too.

The CUDA kernel runs only on a GPU: ``tests/test_torch_cuda.py`` holds it
against the plain version there, and ``chip_smoke.py`` does so at
Llama-3-8B shapes.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas import decode_attention as jda
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.hopper import decode_attention as da

ATOL, RTOL = 2e-6, 2e-5
SHAPES = [(3, 8, 2, 40, 24), (2, 32, 8, 300, 128)]


def _inputs(b, h, kv, s, d, quant, t, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, t, d).astype(np.float32)
    if quant:
        k = rng.randint(-127, 128, size=(b, kv, s, d)).astype(np.int8)
        v = rng.randint(-127, 128, size=(b, kv, s, d)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, size=(b, kv, s)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, size=(b, kv, s)).astype(np.float32)
    else:
        k = rng.randn(b, kv, s, d).astype(np.float32)
        v = rng.randn(b, kv, s, d).astype(np.float32)
        ks = vs = None
    # mixed valid lengths, including the start_pos=0 and s-1 edges
    sp = np.array([0, 7, s - 1][:b] if b == 3 else [0, s - 1][:b], np.int32)
    return q, k, v, sp, ks, vs


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    import jax.numpy as jnp

    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES, ids=["small", "llama3_8b_heads"])
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_plain_matches_jax_xla_decode(shape, t, quant):
    q, k, v, sp, ks, vs = _inputs(*shape, quant=quant, t=t)
    scale = 1.0 / np.sqrt(q.shape[-1])
    ref = jda._xla_decode(*_jax(q, k, v, sp), scale, *_jax(ks, vs))
    out = da.decode_attention_torch(*_torch(q, k, v, sp), scale,
                                    *_torch(ks, vs))
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES, ids=["small", "llama3_8b_heads"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_plain_matches_pallas_kernel_interpret(shape, quant):
    """The TPU kernel itself, through the Pallas interpreter, at T == 1."""
    q, k, v, sp, ks, vs = _inputs(*shape, quant=quant, t=1)
    jda.use_interpret(True)
    try:
        ref = jda.decode_attention(*_jax(q, k, v, sp), k_scale=_jax(ks)[0],
                                   v_scale=_jax(vs)[0])
        assert jda.last_path() == "pallas"
    finally:
        jda.use_interpret(False)
    n0 = da.launch_count()
    out = da.decode_attention(*_torch(q, k, v, sp), k_scale=_torch(ks)[0],
                              v_scale=_torch(vs)[0])
    assert da.last_path() == "torch"
    assert da.launch_count() == n0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_plain_path_without_launch():
    q, k, v, sp, _, _ = _inputs(3, 8, 2, 40, 24, quant=False, t=1)
    n0 = da.launch_count()
    out = da.decode_attention(*_torch(q, k, v, sp))
    assert da.last_path() == "torch"
    assert da.launch_count() == n0
    ref = da.decode_attention_torch(*_torch(q, k, v, sp))
    assert torch.equal(out, ref)


def test_force_path_cuda_on_cpu_raises():
    q, k, v, sp, _, _ = _inputs(3, 8, 2, 40, 24, quant=False, t=1)
    n0 = da.launch_count()
    da.force_path("cuda")
    try:
        with pytest.raises(MXNetError, match="CUDA tensors"):
            da.decode_attention(*_torch(q, k, v, sp))
    finally:
        da.force_path(None)
    assert da.launch_count() == n0
    with pytest.raises(ValueError):
        da.force_path("pallas")


def test_natural_block_is_the_kernel_tile():
    assert da.natural_block() == 32


# -- the kernel's split and merge, mirrored in plain PyTorch -------------------

# (name, (b, h, kv, s, d), start_pos): a share ending inside a tile (37) and
# the ring's last position; a dead row (start_pos -1 gives zeros), a share
# ending on a tile edge (31) and one a position past it (64); rows so short
# that most splits lie wholly past start_pos; Llama-3-8B heads
SPLIT_CASES = [("mixed", (3, 8, 2, 100, 24), [0, 37, 99]),
               ("dead", (3, 8, 2, 100, 24), [-1, 31, 64]),
               ("short", (3, 8, 2, 100, 24), [3, 5, 40]),
               ("llama3_8b_heads", (2, 32, 8, 300, 128), [130, 299])]
_PALLAS_REFS = {}


def _split_inputs(case, quant):
    _, shape, sps = case
    q, k, v, _, ks, vs = _inputs(*shape, quant=quant, t=1)
    return q, k, v, np.array(sps, np.int32), ks, vs


def _pallas_ref(case, quant):
    """The TPU kernel through the Pallas interpreter (computed once per
    case: the interpreter is slow)."""
    key = (case[0], quant)
    if key not in _PALLAS_REFS:
        q, k, v, sp, ks, vs = _split_inputs(case, quant)
        jda.use_interpret(True)
        try:
            ref = jda.decode_attention(*_jax(q, k, v, sp), k_scale=_jax(ks)[0],
                                       v_scale=_jax(vs)[0])
            assert jda.last_path() == "pallas"
        finally:
            jda.use_interpret(False)
        _PALLAS_REFS[key] = np.asarray(ref)
    return _PALLAS_REFS[key]


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_split_mirror_matches_jax(quant, case, n_split):
    """The kernel's share arithmetic and in-order merge, in plain PyTorch,
    against the Pallas kernel (interpret mode) on every row and against
    ``_xla_decode`` on the rows with a live position (``_xla_decode``
    averages V over a row with none, where the kernels give zeros)."""
    q, k, v, sp, ks, vs = _split_inputs(case, quant)
    out = da.decode_attention_split_torch(*_torch(q, k, v, sp), n_split,
                                          k_scale=_torch(ks)[0],
                                          v_scale=_torch(vs)[0]).numpy()
    assert out.shape == q.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, _pallas_ref(case, quant), atol=ATOL,
                               rtol=RTOL)
    scale = 1.0 / np.sqrt(q.shape[-1])
    xla = np.asarray(jda._xla_decode(*_jax(q, k, v, sp), scale,
                                     *_jax(ks, vs)))
    live = sp >= 0
    np.testing.assert_allclose(out[live], xla[live], atol=ATOL, rtol=RTOL)
    assert not out[~live].any()


def test_shares_cover_the_live_positions_in_whole_tiles():
    for n in (0, 1, 31, 32, 33, 281, 8192):
        for n_split in (1, 2, 3, 5, 9, 16, 300):
            shares = da._shares(n, n_split)
            assert len(shares) == n_split
            assert shares[0][0] == 0 and shares[-1][1] == n
            for (lo, hi), (lo2, _) in zip(shares, shares[1:]):
                assert lo <= hi == lo2
                assert hi == n or hi % da.natural_block() == 0
            tiles = [-(-(hi - lo) // da.natural_block()) for lo, hi in shares]
            assert max(tiles) == -(-(-(-n // 32)) // n_split)
            # empty shares are trailing: splits past start_pos
            busy = [hi > lo for lo, hi in shares]
            assert busy == sorted(busy, reverse=True)


# -- split_plan ----------------------------------------------------------------

PLAN_SHAPES = [(b, kv, s, g, d) for b in (1, 2, 4, 16, 64)
               for kv in (1, 8) for s in (1, 32, 100, 1024, 8192)
               for g in (1, 4, 8) for d in (24, 128)]


def test_split_plan_depends_on_shapes_and_sm_count_only():
    import inspect

    assert list(inspect.signature(da.split_plan).parameters) == [
        "b", "kv", "s", "g", "d", "sm_count"]
    for shape in PLAN_SHAPES[::7]:
        assert da.split_plan(*shape, 132) == da.split_plan(*shape, 132)


@pytest.mark.parametrize("sm_count", [1, 78, 132])
def test_split_plan_splits_whole_tiles_and_meets_its_aim(sm_count):
    aim = da.BLOCKS_PER_SM * sm_count
    for b, kv, s, g, d in PLAN_SHAPES:
        plan = da.split_plan(b, kv, s, g, d, sm_count)
        rows = b * kv * -(-g // 4)
        assert plan.groups == -(-g // 4) and plan.grid == (rows, plan.splits)
        assert plan.tiles == -(-s // da.natural_block())
        assert 1 <= plan.splits <= plan.tiles  # never more splits than tiles
        assert plan.workspace_bytes == (
            b * kv * g * plan.splits * (d + 2) * 4 if plan.splits > 1 else 0)
        if rows >= sm_count:  # the (row, head group) blocks fill the card
            assert plan.splits == 1
        elif plan.splits < plan.tiles:  # the ring is long enough: the aim,
            assert plan.blocks >= aim   # with the fewest splits that meet it
            assert rows * (plan.splits - 1) < aim
        else:
            assert plan.blocks < aim or rows * (plan.splits - 1) < aim


def test_split_plan_fills_the_h100_at_llama3_8b_decode():
    """B=4 on Llama-3-8B heads (32 blocks unsplit) gives at least a block a
    SM once the ring is long; the main path's ring too."""
    for s in (1024, 8192):
        plan = da.split_plan(4, 8, s, 4, 128, 132)
        assert plan.blocks >= 132 and plan.splits > 1
    assert da.split_plan(64, 8, 8192, 4, 128, 132).splits == 1

