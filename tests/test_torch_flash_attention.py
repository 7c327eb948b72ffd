"""The port's flash-attention module against the JAX package's.

The same numpy inputs go through the JAX package's ``attention`` with the
Pallas kernels run by the interpreter (``use_interpret(True)``, so
``_flash_core`` and its three TPU kernels run on the CPU), through its
``_reference_attention``, and through the port's ``attention`` on CPU
tensors, which is ``_FlashCore`` on the kernels' plain versions
(``flash_fwd_torch``, ``flash_bwd_dq_torch``, ``flash_bwd_dkv_torch``),
and its ``attention_torch``. Forward and gradients (``jax.vjp`` against
``torch.autograd.grad`` with one cotangent) agree to atol 1e-5 / rtol 1e-5:
the same f32 function, with sums taken in another order (measured ~1e-6).

The CUDA kernels run only on a GPU: ``tests/test_torch_cuda.py`` holds each
against its plain version there, and ``chip_smoke.py`` does so at the
training shape.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas import flash_attention as jfa
from mxnet_tpu_torch import flash_variants as fv
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops.hopper import flash_attention as fa

ATOL, RTOL = 1e-5, 1e-5

# (b, h, tq, tk, d, causal, valid_length)
CASES = [
    (2, 3, 70, 70, 16, True, None),
    (2, 3, 70, 70, 16, False, [0, 33]),       # batch 0: every row dead
    (2, 3, 70, 70, 16, True, [0, 33]),
    (1, 2, 70, 130, 64, True, None),          # Tq < Tk: diagonal offset 60
    (1, 2, 130, 70, 64, True, None),          # Tq > Tk: the first 60 rows dead
    (2, 2, 96, 96, 64, False, [96, 50]),
]
IDS = ["causal-d16", "valid0-d16", "causal-valid0-d16", "tq<tk-d64",
       "tq>tk-d64", "valid-d64"]


def _inputs(b, h, tq, tk, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tk, d).astype(np.float32)
    v = rng.randn(b, h, tk, d).astype(np.float32)
    g = rng.randn(b, h, tq, d).astype(np.float32)
    return q, k, v, g


def _jax_attention(q, k, v, g, causal, vl, flash):
    """Output and (dq, dk, dv) of the JAX package's attention: the Pallas
    kernels through the interpreter when ``flash``, else
    ``_reference_attention``."""
    import jax
    import jax.numpy as jnp

    vlj = None if vl is None else jnp.asarray(np.array(vl, np.int32))
    if flash:
        jfa.use_interpret(True)
    try:
        def f(q_, k_, v_):
            if flash:
                return jfa.attention(q_, k_, v_, causal=causal,
                                     valid_length=vlj)
            return jfa._reference_attention(q_, k_, v_, causal=causal,
                                            valid_length=vlj)

        out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        if flash:
            assert jfa.last_path() == "pallas"
        grads = vjp(jnp.asarray(g))
    finally:
        jfa.use_interpret(False)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _torch_attention(fn, q, k, v, g, causal, vl):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    vlt = None if vl is None else torch.tensor(vl, dtype=torch.int32)
    out = fn(qt, kt, vt, causal=causal, valid_length=vlt)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _close(a, b):
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_core_matches_pallas_interpret_and_reference(case):
    """``_FlashCore`` (the port's attention on CPU tensors) against the
    Pallas kernels and against ``_reference_attention``, forward and
    gradients; ``attention_torch`` against ``_reference_attention``."""
    b, h, tq, tk, d, causal, vl = case
    q, k, v, g = _inputs(b, h, tq, tk, d)
    n0 = fa.launch_count()
    out, grads = _torch_attention(fa.attention, q, k, v, g, causal, vl)
    assert fa.last_path() == "torch" and fa.launch_count() == n0
    pal_out, pal_grads = _jax_attention(q, k, v, g, causal, vl, flash=True)
    ref_out, ref_grads = _jax_attention(q, k, v, g, causal, vl, flash=False)
    _close(out, pal_out)
    _close(out, ref_out)
    for ours, pal, ref in zip(grads, pal_grads, ref_grads):
        _close(ours, pal)
        _close(ours, ref)
    plain_out, plain_grads = _torch_attention(fa.attention_torch, q, k, v, g,
                                              causal, vl)
    _close(plain_out, ref_out)
    for ours, ref in zip(plain_grads, ref_grads):
        _close(ours, ref)
    if vl is not None and vl[0] == 0:  # dead rows: exact zeros, zero grads
        assert not out[0].any() and not plain_out[0].any()
        assert not any(x[0].any() for x in grads)


@pytest.mark.parametrize("case", CASES[:5], ids=IDS[:5])
def test_flash_fwd_plain_lse_matches_pallas(case):
    """``flash_fwd_torch`` on (BH, T, D) gives the Pallas forward's out and
    per-row lse (-1e30 exactly on dead rows)."""
    import jax.numpy as jnp

    b, h, tq, tk, d, causal, vl = case
    q, k, v, _ = _inputs(b, h, tq, tk, d)
    vlj = None if vl is None else jnp.asarray(np.array(vl, np.int32))
    jfa.use_interpret(True)
    try:
        ref_out, res = jfa._flash_core_fwd(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), vlj, causal, None)
    finally:
        jfa.use_interpret(False)
    ref_lse = np.asarray(res[3])[:, :tq]
    kvalid = fa.kvalid_of(None if vl is None else torch.tensor(vl), b, tk,
                          torch.device("cpu"))
    out, lse = fa.flash_fwd_torch(
        torch.from_numpy(q.reshape(b * h, tq, d)),
        torch.from_numpy(k.reshape(b * h, tk, d)),
        torch.from_numpy(v.reshape(b * h, tk, d)), kvalid, causal, tk - tq,
        1.0 / np.sqrt(d))
    assert tuple(out.shape) == (b * h, tq, d) and tuple(lse.shape) == (b * h,
                                                                       tq)
    _close(out.reshape(b, h, tq, d).numpy(), np.asarray(ref_out))
    _close(lse.numpy(), ref_lse)
    dead = ref_lse <= -1e29
    assert np.array_equal(lse.numpy() <= -1e29, dead)
    assert (lse.numpy()[dead] == np.float32(-1e30)).all()


def test_backward_plain_kernels_match_autograd_of_plain_attention():
    """The two backward plain versions, fed the forward's lse and
    ``delta = rowsum(g * out)``, give autograd's gradients of
    ``attention_torch``."""
    b, h, tq, tk, d = 2, 2, 40, 56, 16
    q, k, v, g = _inputs(b, h, tq, tk, d, seed=3)
    vl = [56, 20]
    _, ref = _torch_attention(fa.attention_torch, q, k, v, g, True, vl)
    q3, k3, v3, g3 = (torch.from_numpy(a.reshape(b * h, -1, d))
                      for a in (q, k, v, g))
    kvalid = fa.kvalid_of(torch.tensor(vl), b, tk, torch.device("cpu"))
    sc, off = 1.0 / np.sqrt(d), tk - tq
    out, lse = fa.flash_fwd_torch(q3, k3, v3, kvalid, True, off, sc)
    delta = (g3 * out).sum(-1)
    dq = fa.flash_bwd_dq_torch(q3, k3, v3, g3, lse, delta, kvalid, True,
                               off, sc)
    dk, dv = fa.flash_bwd_dkv_torch(q3, k3, v3, g3, lse, delta, kvalid, True,
                                    off, sc)
    for ours, want in zip((dq, dk, dv), ref):
        _close(ours.reshape(want.shape).numpy(), want)


def test_dense_mask_and_use_flash_false_take_plain_attention():
    """A dense mask, or ``use_flash=False``, runs ``attention_torch`` (the
    JAX package's XLA route), held against ``_reference_attention``."""
    import jax.numpy as jnp

    q, k, v, _ = _inputs(2, 2, 24, 24, 16, seed=1)
    mask = np.random.RandomState(2).rand(2, 1, 24, 24) > 0.3
    mask[0, :, 5] = False  # a dead row
    ref = jfa._reference_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   mask=jnp.asarray(mask))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out = tops.attention(qt, kt, vt, mask=torch.from_numpy(mask))
    assert fa.last_path() == "torch"
    _close(out.numpy(), np.asarray(ref))
    assert not out[0, :, 5].any()
    out2 = tops.attention(qt, kt, vt, causal=True, use_flash=False)
    _close(out2.numpy(), fa.attention_torch(qt, kt, vt, causal=True).numpy())


def test_routing_on_cpu_and_force_path():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 2, 8, 8, 16))
    n0 = fa.launch_count()
    fa.force_path("cuda")
    try:
        with pytest.raises(MXNetError, match="CUDA tensors"):
            fa.attention(q, k, v, causal=True)
    finally:
        fa.force_path(None)
    fa.force_path("torch")
    try:
        out = fa.attention(q, k, v, causal=True)
        assert fa.last_path() == "torch"
    finally:
        fa.force_path(None)
    _close(out.numpy(), fa.attention_torch(q, k, v, causal=True).numpy())
    with pytest.raises(ValueError):
        fa.force_path("pallas")
    # head dim above the kernels' 256 on the CPU: the plain attention
    qw = torch.randn(1, 1, 4, 264)
    out = fa.attention(qw, qw, qw)
    assert fa.last_path() == "torch"
    assert fa.launch_count() == n0 == {"fwd": n0["fwd"],
                                       "bwd_dq": n0["bwd_dq"],
                                       "bwd_dkv": n0["bwd_dkv"]}
    with pytest.raises(MXNetError, match="4-D"):
        fa.attention(q[0], k[0], v[0])



def test_force_path_versions_takes_the_autograd_function_on_plain_versions():
    """``force_path("versions")``: the kernels' plain versions under the
    autograd function (what a CPU call takes anyway), never
    ``attention_torch``: in bf16 its scores stay f32, bit for bit the
    unforced CPU route's, forward and gradients; nothing is launched."""
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(2, 2, 24, 24, 16))
    vl = torch.tensor([24, 0], dtype=torch.int32)

    def run():
        qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
        out = fa.attention(qt, kt, vt, causal=True, valid_length=vl)
        return [out, *torch.autograd.grad(out, (qt, kt, vt), g)]

    n0 = fa.launch_count()
    want = run()
    fa.force_path("versions")
    try:
        got = run()
        assert fa.last_path() == "torch"
    finally:
        fa.force_path(None)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert not got[0][1].any()          # the row with no valid key
    assert fa.launch_count() == n0

def test_kvalid_of_clamps_to_tk():
    kv = fa.kvalid_of(torch.tensor([0, 5, 900]), 3, 64, torch.device("cpu"))
    assert kv.dtype == torch.int32 and kv.tolist() == [0, 5, 64]
    full = fa.kvalid_of(None, 2, 7, torch.device("cpu"))
    assert full.tolist() == [7, 7]


def _tf32(x):
    """``x`` (f32) rounded to TF32, to nearest with ties away from zero on
    the 13 dropped mantissa bits: what ``cvt.rna.tf32.f32`` computes."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_matmul(a, b, passes):
    """a @ b with the backward kernels' operand split, emulated in f32:
    each operand split into hi = tf32(x) and lo = tf32(x - hi), the
    products lo.hi + hi.lo + hi.hi summed in f32 (``passes=3``), or hi.hi
    alone (``passes=1``, single-pass TF32). Only the split is emulated: the
    CPU matmul accumulates with round-to-nearest, where the tensor cores
    truncate, so the kernels' short accumulation chains are held by the
    card's tests (``test_torch_cuda.py``, D=256 among them), not here."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return torch.matmul(a_hi, b_hi)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_hi, b_hi))


def test_tf32_rounding_matches_round_to_nearest():
    """``_tf32`` keeps 10 mantissa bits, rounds the 13 dropped ones to
    nearest with ties away from zero, and leaves TF32 values alone."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -11, 3.0e-3, -7.5], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10),
                         1.0 + 2 * 2.0 ** -10], dtype=torch.float32)
    got = _tf32(x)
    assert torch.equal(got[:5], want)
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()
    assert torch.equal(_tf32(got), got)
    assert float((got[5] - x[5]).abs()) <= 2.0 ** -11 * float(x[5].abs())
    assert float(got[6]) == -7.5


def test_three_tf32_products_keep_backward_within_f32_tolerance():
    """The dq and dk/dv products of the backward kernels (scores, dP,
    dq = dS.K, dv = P^T.dO, dk = dS^T.q) with the 3xTF32 operand split,
    emulated in f32 on the CPU, held to the plain f32 versions at the
    kernels' tolerances (atol 1e-5, rtol 1e-4); single-pass TF32 misses by
    at least ten times as much, which is why the kernels split."""
    b, h, tq, tk, d, causal, vl = CASES[3]
    q, k, v, g = (torch.from_numpy(a.reshape(b * h, -1, d))
                  for a in _inputs(b, h, tq, tk, d, seed=5))
    kvalid = fa.kvalid_of(vl, b, tk, torch.device("cpu"))
    sc, off = 1.0 / np.sqrt(d), tk - tq
    out, lse = fa.flash_fwd_torch(q, k, v, kvalid, causal, off, sc)
    delta = (g * out).sum(-1)
    args = (kvalid, causal, off, sc)
    want = [fa.flash_bwd_dq_torch(q, k, v, g, lse, delta, *args),
            *fa.flash_bwd_dkv_torch(q, k, v, g, lse, delta, *args)]
    keep = fa._keep_mask(kvalid, b * h, tq, tk, causal, off,
                         torch.device("cpu"))
    keep = keep & (lse > -5e29)[:, :, None]
    errs = {}
    for passes in (3, 1):
        s = _split_matmul(q, k.transpose(1, 2), passes) * sc
        p = torch.where(keep, torch.exp(s - lse[:, :, None]),
                        torch.zeros(()))
        ds = p * (_split_matmul(g, v.transpose(1, 2), passes)
                  - delta[:, :, None])
        got = [_split_matmul(ds, k, passes) * sc,
               _split_matmul(ds.transpose(1, 2), q, passes) * sc,
               _split_matmul(p.transpose(1, 2), g, passes)]
        if passes == 3:
            for ours, ref in zip(got, want):
                torch.testing.assert_close(ours, ref, atol=1e-5, rtol=1e-4)
        errs[passes] = max(float((ours - ref).abs().max())
                           for ours, ref in zip(got, want))
    assert errs[1] >= 10 * errs[3], errs


def _bf16_pieces(x, n):
    """``x`` (f32) as ``n`` bf16 values, each rounded to nearest, the way
    the (bf16, bf16) backward kernels split P and dS: hi = bf16(x),
    mid = bf16(x - hi), lo = bf16(x - hi - mid); returned in f32, largest
    first."""
    pieces, rest = [], x
    for _ in range(n):
        piece = rest.to(torch.bfloat16).to(torch.float32)
        pieces.append(piece)
        rest = rest - piece
    return pieces


def _bf16_product(a, b, pieces):
    """a @ b as the (bf16, bf16) backward kernels form it, emulated in f32:
    ``b`` holds bf16 values; ``pieces=None`` takes ``a`` (bf16 values too)
    in one pass, exact products summed in f32, else ``a`` (f32) in that
    many bf16 pieces, one pass each, the small pieces first. As in
    ``_split_matmul``, the tensor cores' truncating accumulation is not
    emulated."""
    if pieces is None:
        return torch.matmul(a, b)
    out = None
    for piece in reversed(_bf16_pieces(a, pieces)):
        part = torch.matmul(piece, b)
        out = part if out is None else out + part
    return out


def test_bf16_products_keep_bf16_backward_within_f32_tolerance():
    """The (bf16, bf16) backward kernels' products on bf16 inputs, emulated
    in f32 on the CPU: S = q K^T and dP = dO V^T in one pass, dq = dS K,
    dk = dS^T q and dv = P^T dO with P and dS (f32) in three bf16 pieces,
    held to the plain f32 versions on the same bf16-valued inputs at the
    kernels' tolerances (atol 1e-5, rtol 1e-4). Rounding P and dS once to
    bf16 (one piece, as cuDNN's and FlashAttention-2's backward do) misses
    by at least ten times as much, which is why the kernels split them."""
    b, h, tq, tk, d, causal, vl = CASES[3]
    q, k, v, g = (torch.from_numpy(a.reshape(b * h, -1, d)).to(
        torch.bfloat16).to(torch.float32)
        for a in _inputs(b, h, tq, tk, d, seed=7))
    kvalid = fa.kvalid_of(vl, b, tk, torch.device("cpu"))
    sc, off = 1.0 / np.sqrt(d), tk - tq
    out, lse = fa.flash_fwd_torch(q, k, v, kvalid, causal, off, sc)
    delta = (g * out).sum(-1)
    args = (kvalid, causal, off, sc)
    want = [fa.flash_bwd_dq_torch(q, k, v, g, lse, delta, *args),
            *fa.flash_bwd_dkv_torch(q, k, v, g, lse, delta, *args)]
    keep = fa._keep_mask(kvalid, b * h, tq, tk, causal, off,
                         torch.device("cpu"))
    keep = keep & (lse > -5e29)[:, :, None]
    s = _bf16_product(q, k.transpose(1, 2), None) * sc
    p = torch.where(keep, torch.exp(s - lse[:, :, None]), torch.zeros(()))
    ds = p * (_bf16_product(g, v.transpose(1, 2), None) - delta[:, :, None])
    errs = {}
    for pieces in (3, 1):
        got = [_bf16_product(ds, k, pieces) * sc,
               _bf16_product(ds.transpose(1, 2), q, pieces) * sc,
               _bf16_product(p.transpose(1, 2), g, pieces)]
        if pieces == 3:
            for ours, ref in zip(got, want):
                torch.testing.assert_close(ours, ref, atol=1e-5, rtol=1e-4)
        errs[pieces] = max(float((ours - ref).abs().max())
                           for ours, ref in zip(got, want))
    assert errs[1] >= 10 * errs[3], errs


@pytest.mark.parametrize("case", [CASES[3], CASES[4]],
                         ids=["tq<tk-d64", "tq>tk-d64"])
def test_bf16_products_keep_bf16_forward_within_f32_tolerance(case):
    """The (bf16, bf16) forward kernel's products on bf16 inputs, emulated
    in f32 on the CPU: S = q K^T in one pass (exact products summed in
    f32, then scaled), the softmax between them formed as
    ``flash_fwd_torch`` forms it, and P V with P (f32) in three bf16
    pieces, held to ``flash_fwd_torch`` on the same bf16-valued inputs at
    the kernels' tolerances (atol 1e-5, rtol 1e-4). Rounding P once to bf16
    (one piece, as cuDNN's and FlashAttention-2's forward do) misses by at
    least ten times as much, which is why the kernel splits it."""
    b, h, tq, tk, d, causal, vl = case
    q, k, v = (torch.from_numpy(a.reshape(b * h, -1, d)).to(
        torch.bfloat16).to(torch.float32)
        for a in _inputs(b, h, tq, tk, d, seed=8)[:3])
    kvalid = fa.kvalid_of(vl, b, tk, torch.device("cpu"))
    sc, off = 1.0 / np.sqrt(d), tk - tq
    want = fa.flash_fwd_torch(q, k, v, kvalid, causal, off, sc)
    keep = fa._keep_mask(kvalid, b * h, tq, tk, causal, off,
                         torch.device("cpu"))
    neg = torch.tensor(-1e30)
    s = torch.where(keep, _bf16_product(q, k.transpose(1, 2), None) * sc,
                    neg)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(m > -5e29, torch.exp(s - m), torch.zeros(()))
    l = p.sum(dim=-1, keepdim=True)
    lsafe = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l == 0, neg, m + torch.log(lsafe))[..., 0]
    errs = {}
    for pieces in (3, 1):
        got = [_bf16_product(p, v, pieces) / lsafe, lse]
        if pieces == 3:
            for ours, ref in zip(got, want):
                torch.testing.assert_close(ours, ref, atol=1e-5, rtol=1e-4)
        errs[pieces] = max(float((ours - ref).abs().max())
                           for ours, ref in zip(got, want))
    assert errs[1] >= 10 * errs[3], errs


def test_three_bf16_pieces_reconstruct_f32():
    """hi + mid + lo gives an f32 value back within 2^-24 of its size, the
    bound the kernels' split states: each rounding to bf16's 8 significand
    bits leaves at most 2^-8 of what it rounds (so one piece misses by up
    to 2^-8, two by 2^-16), and each subtraction is exact. Every piece is a
    bf16 value. Checked over P-like values in [0, 1], signed dS-like values
    across 60 binades, and values whose rounding carries into the next
    power of two."""
    rng = np.random.RandomState(11)
    x = np.concatenate([
        rng.rand(4000),
        rng.randn(4000) * 10.0 ** rng.uniform(-20, 8, 4000),
        np.nextafter(np.float32(2.0) ** np.arange(-30, 30), np.float32(0)),
        1 + 2.0 ** -8 + 2.0 ** -16 + np.arange(1, 50) * 2.0 ** -23,
    ]).astype(np.float32)
    x = torch.from_numpy(x)
    hi, mid, lo = _bf16_pieces(x, 3)
    for piece in (hi, mid, lo):
        assert torch.equal(piece.to(torch.bfloat16).to(torch.float32), piece)
    mag = x.abs().double()
    for n, pieces, bound in ((3, (hi, mid, lo), 2.0 ** -24),
                             (2, (hi, mid), 2.0 ** -16), (1, (hi,), 2.0 ** -8)):
        total = sum(p.double() for p in pieces)
        err = (x.double() - total).abs()
        assert bool((err <= bound * mag).all()), (n, float((err / mag).max()))
    # the third piece is needed: two leave more than f32's own rounding
    two = (x.double() - hi.double() - mid.double()).abs()
    assert float((two / mag).max()) > 2.0 ** -24


@pytest.mark.parametrize("name", sorted(fv.VARIANTS))
def test_flash_variants_apply_to_the_kernel_source(name):
    """Each variant that ``flash_variants`` builds applies to the kernels'
    source as it stands: every text it replaces occurs there, and every
    variant but the source itself changes it."""
    from mxnet_tpu_torch.ops.hopper._build import CSRC

    source = (CSRC / "flash_attention.cu").read_text()
    subs = fv.VARIANTS[name]
    assert (fv.variant_source(source, subs) == source) == (not subs)


def test_flash_variants_refuses_missing_text_and_needs_cuda(capsys):
    with pytest.raises(ValueError, match="not in the source"):
        fv.variant_source("int x;", [("float y;", "")])
    assert fv.main() == 2  # no card here: no build, no result
    assert "CUDA is not available" in capsys.readouterr().err


@pytest.mark.parametrize("case", [CASES[3], CASES[4]],
                         ids=["tq<tk-d64", "tq>tk-d64"])
def test_three_tf32_products_keep_forward_within_f32_tolerance(case):
    """The forward kernel's two products, S = (q.scale) K^T and P.V, with
    the 3xTF32 operand split, emulated in f32 on the CPU, and the softmax
    between them formed as ``flash_fwd_torch`` forms it, held to
    ``flash_fwd_torch`` at the kernels' tolerances (atol 1e-5, rtol 1e-4);
    single-pass TF32 misses by at least ten times as much. Only the operand
    split is emulated, not the tensor cores' truncating accumulation (see
    ``_split_matmul``)."""
    b, h, tq, tk, d, causal, vl = case
    q, k, v, _ = (torch.from_numpy(a.reshape(b * h, -1, d))
                  for a in _inputs(b, h, tq, tk, d, seed=6))
    kvalid = fa.kvalid_of(vl, b, tk, torch.device("cpu"))
    sc, off = 1.0 / np.sqrt(d), tk - tq
    want = fa.flash_fwd_torch(q, k, v, kvalid, causal, off, sc)
    keep = fa._keep_mask(kvalid, b * h, tq, tk, causal, off,
                         torch.device("cpu"))
    neg = torch.tensor(-1e30)
    errs = {}
    for passes in (3, 1):
        s = torch.where(keep, _split_matmul(q * sc, k.transpose(1, 2),
                                            passes), neg)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.where(m > -5e29, torch.exp(s - m), torch.zeros(()))
        l = p.sum(dim=-1, keepdim=True)
        lsafe = torch.where(l == 0, torch.ones_like(l), l)
        got = [_split_matmul(p, v, passes) / lsafe,
               torch.where(l == 0, neg, m + torch.log(lsafe))[..., 0]]
        if passes == 3:
            for ours, ref in zip(got, want):
                torch.testing.assert_close(ours, ref, atol=1e-5, rtol=1e-4)
        errs[passes] = max(float((ours - ref).abs().max())
                           for ours, ref in zip(got, want))
    assert errs[1] >= 10 * errs[3], errs


# -- the reference's mixed input dtypes -----------------------------------------

# (q/k dtype, v dtype) of the kernels' instantiations other than f32
PAIRS = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
         (torch.float16, torch.float16)]
PAIR_IDS = ["f32-bf16", "bf16", "f16"]
_MANT = {torch.bfloat16: 7, torch.float16: 10}


def _ulp(ref, dtype):
    """One unit in the last place of ``dtype`` at |ref| (0 for f32)."""
    if dtype not in _MANT:
        return np.zeros_like(ref)
    _, e = np.frexp(np.abs(ref).astype(np.float64))
    lo = -14 if dtype == torch.float16 else -126
    return np.ldexp(1.0, np.maximum(e - 1, lo) - _MANT[dtype])


def _close_dtype(ours, ref, dtype, scale=None):
    """Within the f32 tolerance plus one unit in the last place of the
    output's dtype, at the larger of the two values (a rounding across a
    power of two counts as one unit) or, given ``scale``, at ``scale``."""
    ours, ref = ours.astype(np.float32), ref.astype(np.float32)
    at = np.maximum(np.abs(ours), np.abs(ref)) if scale is None else scale
    bound = ATOL + RTOL * np.abs(ref) + _ulp(np.asarray(at), dtype)
    bad = np.abs(ours - ref) > bound
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} beyond "
                           f"tolerance, max {np.abs(ours - ref).max()}")


def _jax_dtype(pair):
    return [{torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.float16: "float16"}[t] for t in pair]


@pytest.mark.parametrize("case", [CASES[2], CASES[4]],
                         ids=["causal-valid0", "tq>tk"])
@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_flash_core_mixed_dtypes_match_pallas_interpret(pair, case):
    """``_FlashCore`` on the kernels' plain versions against the Pallas
    kernels (interpreter) on the same rounded inputs: out and dq in q's
    dtype, dk in k's, dv in v's. Each computes in f32 and rounds once, so
    out is within one unit in the last place of its dtype beyond the f32
    tolerance. The backward reads that rounded out (delta = rowsum(g out)),
    so one unit of out moves a gradient by an amount set by the gradients'
    scale, not by the element's own size: a gradient is held to one unit
    at its tensor's largest magnitude. Dead rows are exact zeros."""
    import jax
    import jax.numpy as jnp

    b, h, tq, tk, d, causal, vl = case
    qk, vt = pair
    arrays = _inputs(b, h, tq, tk, d, seed=3)
    ts = [torch.from_numpy(a).to(t)
          for a, t in zip(arrays, (qk, qk, vt, qk))]
    jq, jv = _jax_dtype(pair)
    js = [jnp.asarray(t.float().numpy()).astype(dt)
          for t, dt in zip(ts, (jq, jq, jv, jq))]
    vlj = None if vl is None else jnp.asarray(np.array(vl, np.int32))
    jfa.use_interpret(True)
    try:
        ref_out, vjp = jax.vjp(
            lambda q_, k_, v_: jfa.attention(q_, k_, v_, causal=causal,
                                             valid_length=vlj), *js[:3])
        assert jfa.last_path() == "pallas"
        ref_grads = vjp(js[3])
    finally:
        jfa.use_interpret(False)
    leaves = [t.clone().requires_grad_() for t in ts[:3]]
    vlt = None if vl is None else torch.tensor(vl, dtype=torch.int32)
    out = fa.attention(*leaves, causal=causal, valid_length=vlt)
    grads = torch.autograd.grad(out, leaves, ts[3])
    assert fa.last_path() == "torch"
    for ours, ref, dt in zip((out,) + grads, (ref_out,) + tuple(ref_grads),
                             (qk, qk, qk, vt)):
        assert ours.dtype == dt and str(ref.dtype) == _jax_dtype((dt, dt))[0]
        ref = np.asarray(ref.astype(jnp.float32))
        _close_dtype(ours.detach().float().numpy(), ref, dt,
                     scale=None if ours is out else np.abs(ref).max())
    if vl is not None and vl[0] == 0:
        assert not out[0].any() and not any(x[0].any() for x in grads)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_plain_attention_promotes_as_reference_attention(pair):
    """``attention_torch`` (the dense-mask route) on mixed dtypes gives
    ``_reference_attention``'s output dtype and values under ``jnp``
    promotion."""
    import jax.numpy as jnp

    b, h, tq, tk, d, causal, vl = CASES[2]
    qk, vt = pair
    arrays = _inputs(b, h, tq, tk, d, seed=5)
    ts = [torch.from_numpy(a).to(t) for a, t in zip(arrays, (qk, qk, vt))]
    jq, jv = _jax_dtype(pair)
    ref = jfa._reference_attention(
        *[jnp.asarray(t.float().numpy()).astype(dt)
          for t, dt in zip(ts, (jq, jq, jv))], causal=causal,
        valid_length=jnp.asarray(np.array(vl, np.int32)))
    out = fa.attention_torch(*ts, causal=causal,
                             valid_length=torch.tensor(vl))
    want = torch.promote_types(qk, vt)
    assert out.dtype == want and str(ref.dtype) == _jax_dtype((want, want))[0]
    # a product in the working dtype: the scores and weights round there
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=3e-2 if want != torch.float32 else 1e-5,
                               rtol=0)


def test_kernel_dtype_pairs_and_refusals():
    """The wrapper names each instantiation, builds a library per pair
    (the f32 one with no defines) and refuses, before any launch, a pair
    with no instantiation or k of another dtype than q."""
    assert [fa.pair_label(p) for p in fa.DTYPE_PAIRS] == [
        "f32", "f32_bf16", "f32_f16", "bf16", "f16"]
    assert fa.build_spec(fa.DTYPE_PAIRS[0]) == ("flash_attention", ())
    assert fa.build_spec((torch.float16, torch.float16)) == (
        "flash_attention", ("MXTT_FLASH_QK=2", "MXTT_FLASH_V=2"))
    kvalid = torch.full((1,), 8, dtype=torch.int32)

    def qkv(qk, k, v):
        return (torch.zeros(2, 8, 16, dtype=qk), torch.zeros(2, 8, 16,
                                                             dtype=k),
                torch.zeros(2, 8, 16, dtype=v))

    for pair in fa.DTYPE_PAIRS:
        assert fa._check_launch("fwd", *qkv(pair[0], *pair), kvalid,
                                []) == pair
    for q_dt, k_dt, v_dt in [(torch.bfloat16, torch.bfloat16, torch.float32),
                             (torch.float16, torch.float16, torch.bfloat16),
                             (torch.float32, torch.bfloat16, torch.bfloat16),
                             (torch.float64, torch.float64, torch.float64)]:
        with pytest.raises(MXNetError, match="no instantiation"):
            fa._check_launch("fwd", *qkv(q_dt, k_dt, v_dt), kvalid, [])
    q, k, v = qkv(torch.bfloat16, torch.bfloat16, torch.bfloat16)
    rows = (2, 8)
    for label, bad in (("g", {"g": q.float()}),
                       ("lse", {"lse": torch.zeros(rows,
                                                   dtype=torch.bfloat16)})):
        rest = {"g": q, "lse": torch.zeros(rows), "delta": torch.zeros(rows)}
        rest.update(bad)
        with pytest.raises(MXNetError, match=f"{label} must be"):
            fa._check_launch("bwd_dq", q, k, v, kvalid,
                             fa._bwd_rest(q, rest["g"], rest["lse"],
                                          rest["delta"]))
    assert fa.launch_count((torch.float32, torch.bfloat16)) == dict.fromkeys(
        fa.KERNELS, 0)
