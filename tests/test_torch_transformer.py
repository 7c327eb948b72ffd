"""The port's transformer pieces (``ops.nn``'s new ops, the new
``gluon.nn`` layers, ``models.transformer``) against the JAX package's on
the same numpy inputs and the same weights (``load_reference_params``).

Sizes are the JAX package's own tiny test sizes (``tests/test_models.py``):
units 32, FFN 64, 4 heads, 2 layers, vocabulary 50-100, dropout 0. The
JAX attention runs its XLA reference on the CPU, and once (``pallas``) the
Pallas flash kernel in interpret mode; the port's runs the flash kernels'
plain versions through the same autograd function the card uses.

Tolerance: 1e-5 of the largest output unless stated; the two packages
compute the same f32 arithmetic, in other orders. Gradients: 1e-5 of the
largest gradient of the block's weights. The key projection's bias has an
exact zero gradient (the softmax does not move when every score of a row
moves by the same amount), so its own largest entry is rounding noise.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, gluon as jgluon
from mxnet_tpu import numpy as mnp
from mxnet_tpu.models import transformer as jtr
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.ops import registry as jregistry
from mxnet_tpu.ops.pallas import flash_attention as jfa
from mxnet_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from mxnet_tpu.parallel import make_mesh as jax_make_mesh
from mxnet_tpu_torch import models, random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.models import load_reference_params
from mxnet_tpu_torch.models import transformer as ttr
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops.hopper import flash_attention as fa
from mxnet_tpu_torch.parallel import ShardedTrainer

TOL = 1e-5
UNITS, HIDDEN, HEADS = 32, 64, 4
F32, BF16 = torch.float32, torch.bfloat16


def _np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref, tol=TOL):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= tol * scale, (err, scale)


def _close_grads(module, ref_grads):
    """Every weight's gradient within TOL of the largest one of them."""
    grads = {n: p.grad for n, p in
             module.named_parameters(remove_duplicate=False)}
    assert sorted(grads) == sorted(ref_grads)
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    for name, g in grads.items():
        err = float(np.abs(_np(g) - ref_grads[name]).max())
        assert err <= TOL * scale, (name, err, scale)


def _jax_params(block):
    return {k: v.data().asnumpy() for k, v in block.collect_params().items()}


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- ops ------------------------------------------------------------------


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "erf_gelu", "tanh",
                                 "relu", "silu"])
def test_activation_matches_jax(act):
    x = np.random.RandomState(0).randn(4, 33).astype(np.float32) * 3
    _close(tops.activation(_t(x), act), jops.activation(mnp.array(x), act),
           1e-6)


def test_gelu_is_jax_nn_gelu_default():
    """The JAX package's "gelu" is ``jax.nn.gelu``'s default, the tanh
    approximation, not the exact erf form."""
    import jax

    x = np.linspace(-4, 4, 257).astype(np.float32)
    _close(tops.activation(_t(x), "gelu"), np.asarray(jax.nn.gelu(x)), 1e-6)
    exact = tops.activation(_t(x), "erf_gelu")
    assert float((exact - tops.activation(_t(x), "gelu")).abs().max()) > 1e-4
    with pytest.raises(MXNetError, match="not ported"):
        tops.activation(_t(x), "mish")


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_matches_jax(axis):
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 7) * 4 + 2).astype(np.float32)
    c = x.shape[axis]
    g = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    for eps in (1e-5, 1e-12):
        _close(tops.layer_norm(_t(x), _t(g), _t(b), axis=axis, eps=eps),
               jops.layer_norm(mnp.array(x), mnp.array(g), mnp.array(b),
                               axis=axis, eps=eps))


@pytest.mark.parametrize("flatten,no_bias", [(True, False), (False, False),
                                             (False, True)])
def test_fully_connected_matches_jax(flatten, no_bias):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4, 6).astype(np.float32)
    w = rng.randn(5, 24 if flatten else 6).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    ref = jops.fully_connected(mnp.array(x), mnp.array(w), mnp.array(b),
                               num_hidden=5, no_bias=no_bias, flatten=flatten)
    out = tops.fully_connected(_t(x), _t(w), _t(b), num_hidden=5,
                               no_bias=no_bias, flatten=flatten)
    _close(out, ref)
    # bf16 data against an f32 weight promotes to f32, as jnp does
    mixed = tops.fully_connected(_t(x).to(BF16), _t(w), _t(b),
                                 flatten=flatten, no_bias=no_bias)
    assert mixed.dtype == F32


def test_embedding_matches_jax_and_refuses_sparse_grad():
    rng = np.random.RandomState(3)
    w = rng.randn(11, 4).astype(np.float32)
    idx = rng.randint(0, 11, (3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tops.embedding(_t(idx), _t(w))),
        _np(jops.embedding(mnp.array(idx), mnp.array(w))))
    with pytest.raises(MXNetError, match="A.7"):
        tops.embedding(_t(idx), _t(w), sparse_grad=True)
    with pytest.raises(MXNetError, match="A.7"):
        tnn.Embedding(11, 4, sparse_grad=True)


def test_dropout_rate_scale_axes_and_modes():
    """The bits are the port's own (not threefry's), so the contract is
    checked by its properties: identity when not training or at p = 0,
    kept elements scaled by 1 / (1 - p), a keep rate near 1 - p, one draw
    shared along ``axes``, and the same mask from the same seed."""
    x = torch.ones(64, 32, 16)
    assert tops.dropout(x, 0.3) is x                      # not training
    assert tops.dropout(x, 0.0, training=True) is x
    gen = torch.Generator().manual_seed(5)
    y = tops.dropout(x, 0.3, training=True, generator=gen)
    kept = y != 0
    np.testing.assert_allclose(_np(y[kept]), 1 / 0.7, rtol=1e-6)
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    z = tops.dropout(x, 0.5, axes=(1,), training=True,
                     generator=torch.Generator().manual_seed(6))
    assert bool((z == z[:, :1]).all())                    # shared along 1
    again = tops.dropout(x, 0.3, training=True,
                         generator=torch.Generator().manual_seed(5))
    assert torch.equal(again, y)
    # bf16 draws the same mask as f32
    yb = tops.dropout(x.to(BF16), 0.3, training=True,
                      generator=torch.Generator().manual_seed(5))
    assert torch.equal(yb != 0, kept)
    # the layer acts only in train() mode
    layer = tnn.Dropout(0.5)
    assert not torch.equal(layer(x), x)
    assert torch.equal(layer.eval()(x), x)
    # the JAX op: identity outside training, and the same scale inside
    np.testing.assert_array_equal(_np(jops.dropout(mnp.array(x.numpy()),
                                                   p=0.3)), x.numpy())
    with autograd.record():
        jy = _np(jops.dropout(mnp.array(x.numpy()), p=0.3))
    np.testing.assert_allclose(jy[jy != 0], 1 / 0.7, rtol=1e-6)


# -- layers ---------------------------------------------------------------


def _jax_layer(layer, x):
    mx.random.seed(0)
    layer.initialize()
    with autograd.predict_mode():
        out = layer(mnp.array(x))
    return out, _jax_params(layer)


@pytest.mark.parametrize("kind", ["dense", "dense_gelu_3d", "dense_tanh",
                                  "layer_norm", "embedding", "gelu_erf",
                                  "gelu_tanh", "dropout_eval"])
def test_layers_match_jax(kind):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 6).astype(np.float32)
    if kind == "dense":
        j, t = jgluon.nn.Dense(7), tnn.Dense(7, in_units=30)
    elif kind == "dense_gelu_3d":
        j = jgluon.nn.Dense(7, activation="gelu", flatten=False)
        t = tnn.Dense(7, activation="gelu", flatten=False, in_units=6)
    elif kind == "dense_tanh":
        j = jgluon.nn.Dense(7, activation="tanh", flatten=False)
        t = tnn.Dense(7, activation="tanh", flatten=False, in_units=6)
    elif kind == "layer_norm":
        j = jgluon.nn.LayerNorm(epsilon=1e-12)
        t = tnn.LayerNorm(epsilon=1e-12, in_channels=6)
    elif kind == "embedding":
        x = rng.randint(0, 9, (3, 5)).astype(np.int32)
        j, t = jgluon.nn.Embedding(9, 6), tnn.Embedding(9, 6)
    elif kind.startswith("gelu"):
        approx = kind.split("_")[1]
        j, t = jgluon.nn.GELU(approx), tnn.GELU(approx)
    else:
        j, t = jgluon.nn.Dropout(0.5), tnn.Dropout(0.5).eval()
    ref, params = _jax_layer(j, x)
    load_reference_params(t, params)
    _close(t(_t(x)), ref)


# -- blocks ---------------------------------------------------------------

_CASES = {
    # name: (causal, Tq, Tk, valid_length); Tk differs from Tq: cross
    "self": (False, 10, 10, None),
    "self_valid_length": (False, 10, 10, [10, 0, 4]),
    "cross": (False, 7, 12, [12, 5, 0]),
    "causal": (True, 9, 9, None),
    "causal_valid_length": (True, 9, 9, [9, 3, 0]),
}


def _mha_pair(causal):
    mx.random.seed(0)
    j = jtr.MultiHeadAttention(UNITS, HEADS, causal=causal)
    t = ttr.MultiHeadAttention(UNITS, HEADS, causal=causal)
    return j, t


def _jax_forward_backward(block, args, cot, **kw):
    """(output, {name: gradient}) of ``(block(*args) * cot).sum()``."""
    with autograd.record():
        out = block(*args, **kw)
        loss = (out * mnp.array(cot)).sum()
    loss.backward()
    return out, {k: v.grad().asnumpy()
                 for k, v in block.collect_params().items()}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_multi_head_attention_matches_jax(case):
    """Forward and every weight's gradient; a query row whose batch row has
    ``valid_length`` 0 gives zeros in both packages (no NaN)."""
    causal, tq, tk, vl = _CASES[case]
    rng = np.random.RandomState(5)
    q = rng.randn(3, tq, UNITS).astype(np.float32)
    kv = rng.randn(3, tk, UNITS).astype(np.float32)
    cot = rng.randn(3, tq, UNITS).astype(np.float32)
    j, t = _mha_pair(causal)
    j.initialize()
    jkv = None if tk == tq else mnp.array(kv)
    jvl = None if vl is None else mnp.array(np.array(vl, np.int32))
    with autograd.predict_mode():
        j(mnp.array(q), jkv, jkv, valid_length=jvl)
    load_reference_params(t, _jax_params(j))
    ref, ref_g = _jax_forward_backward(j, (mnp.array(q), jkv, jkv), cot,
                                       valid_length=jvl)
    tkv = None if tk == tq else _t(kv)
    out = t(_t(q), tkv, tkv, valid_length=None if vl is None else _t(
        np.array(vl)))
    (out * _t(cot)).sum().backward()
    assert fa.last_path() == "torch"
    _close(out, ref)
    _close_grads(t, ref_g)
    if vl is not None and 0 in vl:
        row = vl.index(0)
        # attention gives zeros there; the output projection adds its bias
        bias = t.out_proj.bias.detach()
        assert torch.equal(out[row].detach(), bias.expand(tq, UNITS))
    assert bool(torch.isfinite(out).all())


def test_multi_head_attention_matches_jax_pallas_interpret():
    """The JAX attention on its Pallas flash kernel (interpret mode, T=64,
    as the JAX package's own kernel tests run it) against the port's."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 64, UNITS).astype(np.float32)
    vl = np.array([64, 37], np.int32)
    j, t = _mha_pair(False)
    j.initialize()
    with autograd.predict_mode():
        j(mnp.array(x), valid_length=mnp.array(vl))
    load_reference_params(t, _jax_params(j))
    jfa.use_interpret(True)
    try:
        with autograd.predict_mode():
            ref = j(mnp.array(x), valid_length=mnp.array(vl))
        assert jfa.last_path() == "pallas"
    finally:
        jfa.use_interpret(False)
    with torch.no_grad():
        _close(t(_t(x), valid_length=_t(vl)), ref)


@pytest.mark.parametrize("cell", ["post_norm", "pre_norm", "decoder"])
def test_cells_match_jax(cell):
    rng = np.random.RandomState(7)
    x = rng.randn(3, 8, UNITS).astype(np.float32)
    mem = rng.randn(3, 11, UNITS).astype(np.float32)
    vl = np.array([8, 2, 5] if cell != "decoder" else [11, 0, 6], np.int32)
    cot = rng.randn(3, 8, UNITS).astype(np.float32)
    mx.random.seed(0)
    if cell == "decoder":
        j = jtr.TransformerDecoderCell(UNITS, HIDDEN, HEADS)
        t = ttr.TransformerDecoderCell(UNITS, HIDDEN, HEADS)
        jargs, targs = (mnp.array(x), mnp.array(mem)), (_t(x), _t(mem))
        jkw, tkw = ({"mem_valid_length": mnp.array(vl)},
                    {"mem_valid_length": _t(vl)})
    else:
        pre = cell == "pre_norm"
        j = jtr.TransformerEncoderCell(UNITS, HIDDEN, HEADS, pre_norm=pre)
        t = ttr.TransformerEncoderCell(UNITS, HIDDEN, HEADS, pre_norm=pre)
        jargs, targs = (mnp.array(x),), (_t(x),)
        jkw, tkw = {"valid_length": mnp.array(vl)}, {"valid_length": _t(vl)}
    j.initialize()
    with autograd.predict_mode():
        j(*jargs, **jkw)
    load_reference_params(t, _jax_params(j))
    ref, ref_g = _jax_forward_backward(j, jargs, cot, **jkw)
    out = t(*targs, **tkw)
    (out * _t(cot)).sum().backward()
    _close(out, ref)
    _close_grads(t, ref_g)


@pytest.mark.parametrize("units", [32, 33])
def test_sinusoid_table_matches_jax(units):
    """Odd units: the cos half is one column shorter, as in the JAX
    table."""
    np.testing.assert_array_equal(ttr._sinusoid_table(20, units),
                                  jtr._sinusoid_table(20, units))
    pe = ttr.PositionalEmbedding(units, max_length=16, learned=False)
    with pytest.raises(MXNetError, match="max_length"):
        pe(torch.zeros(1, 17, units))


def _mt_pair(tie):
    mx.random.seed(0)
    kw = dict(units=UNITS, hidden_size=HIDDEN, num_heads=HEADS,
              num_encoder_layers=2, num_decoder_layers=2, dropout=0.0)
    j = jtr.Transformer(src_vocab_size=50, tgt_vocab_size=None if tie else 60,
                        tie_embeddings=tie, **kw)
    j.initialize()
    rng = np.random.RandomState(8)
    src = rng.randint(0, 50, (3, 10)).astype(np.int32)
    tgt = rng.randint(0, 50, (3, 7)).astype(np.int32)
    svl = np.array([10, 6, 0], np.int32)
    with autograd.predict_mode():
        j(mnp.array(src), mnp.array(tgt), mnp.array(svl))
    t = ttr.Transformer(50, None if tie else 60, tie_embeddings=tie,
                        device="cpu", **kw)
    return j, load_reference_params(t, _jax_params(j)), src, tgt, svl


@pytest.mark.parametrize("tie", [False, True], ids=["separate", "tied"])
def test_transformer_forward_and_gradients_match_jax(tie):
    """``Transformer.forward``: encoder non-causal with ``valid_length``
    (one row 0), decoder causal self-attention and cross-attention with
    Tq != Tk; every weight's gradient, the tied embedding's once under
    both of its names."""
    j, t, src, tgt, svl = _mt_pair(tie)
    vocab = 50 if tie else 60
    cot = np.random.RandomState(9).randn(3, 7, vocab).astype(np.float32)
    ref, ref_g = _jax_forward_backward(
        j, (mnp.array(src), mnp.array(tgt), mnp.array(svl)), cot)
    out = t(_t(src).long(), _t(tgt).long(), _t(svl))
    (out * _t(cot)).sum().backward()
    _close(out, ref)
    _close_grads(t, ref_g)
    names = [n for n, _ in t.named_parameters(remove_duplicate=False)]
    if tie:
        assert t.src_embed.weight is t.tgt_embed.weight
        assert len(list(t.parameters())) == len(names) - 1


def test_transformer_decoder_is_causal_and_loader_refuses():
    _, t, src, tgt, svl = _mt_pair(True)
    with torch.no_grad():
        a = t(_t(src).long(), _t(tgt).long(), _t(svl))
        tgt2 = tgt.copy()
        tgt2[0, 5] = (tgt2[0, 5] + 1) % 50
        b = t(_t(src).long(), _t(tgt2).long(), _t(svl))
    assert torch.equal(a[0, :5], b[0, :5])
    assert float((a[0, 5:] - b[0, 5:]).abs().max()) > 1e-6
    params = {n: p.detach().numpy().copy()
              for n, p in t.named_parameters(remove_duplicate=False)}
    params["tgt_embed.weight"] = params["tgt_embed.weight"] + 1.0
    with pytest.raises(MXNetError, match="tied"):
        load_reference_params(t, params)
    del params["tgt_embed.weight"]
    with pytest.raises(MXNetError, match="missing"):
        load_reference_params(t, params)


def test_transformer_seeded_build_and_sharding_rules():
    kw = dict(units=UNITS, hidden_size=HIDDEN, num_heads=HEADS,
              num_encoder_layers=1, num_decoder_layers=1, device="cpu")
    trandom.seed(3)
    a = ttr.Transformer(20, **kw)
    trandom.seed(3)
    b = ttr.Transformer(20, **kw)
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
        if n.endswith(("gamma",)):
            assert bool((pa == 1).all())
        elif n.endswith(("bias", "beta")):
            assert not bool(pa.any())
        else:
            assert 0 < float(pa.detach().abs().max()) <= 0.07
    rules = ttr.transformer_sharding_rules()
    ref = jtr.transformer_sharding_rules()
    assert [r[0] for r in rules] == [r[0] for r in ref]
    assert [tuple(r[1]) for r in rules] == [tuple(r[1]) for r in ref]
    assert models.Transformer is ttr.Transformer


def test_bf16_transformer_attention_dtypes_match_jax():
    """Under ``ShardedTrainer(dtype="bfloat16")`` the f32 sinusoid table
    promotes the bf16 embedding in both packages, so every attention (the
    encoder's, the decoder's causal self-attention and its cross-attention)
    takes f32 q, k and v: recorded from the JAX trainer's trace and held.
    The losses agree within 5e-3 (one step of bf16-rounded weights; the
    attention runs in f32 after that)."""
    j, t, src, tgt, svl = _mt_pair(False)
    labels = np.random.RandomState(10).randint(0, 60, (3, 7)).astype(np.int32)
    seen, orig = [], jfa.attention

    def spy(q, k, v, *args, **kw):
        seen.append(tuple(str(a.dtype) for a in (q, k, v)))
        return orig(q, k, v, *args, **kw)

    jfa.attention = spy
    jregistry.set_eager_jit(False)
    try:
        jt = JaxShardedTrainer(j, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               "adam", {"learning_rate": 1e-3},
                               mesh=jax_make_mesh({"dp": 1}),
                               dtype="bfloat16")
        ref = float(jt.step((src, tgt, svl), labels).asnumpy())
    finally:
        jregistry.set_eager_jit(True)
        jfa.attention = orig
    assert seen == [("float32",) * 3] * 6, seen   # 2 enc + 2 x 2 dec
    got, orig_fwd = [], fa._FlashCore.forward

    def tspy(ctx, q, k, v, *args):
        got.append((q.dtype, k.dtype, v.dtype))
        return orig_fwd(ctx, q, k, v, *args)

    fa._FlashCore.forward = staticmethod(tspy)
    try:
        tr = ShardedTrainer(t, tloss.SoftmaxCrossEntropyLoss(), "adam",
                            {"learning_rate": 1e-3}, dtype="bfloat16")
        loss = float(tr.step((_t(src).long(), _t(tgt).long(), _t(svl)),
                             _t(labels).long()))
    finally:
        fa._FlashCore.forward = staticmethod(orig_fwd)
    assert got == [(F32, F32, F32)] * 6, got
    assert abs(loss - ref) <= 5e-3, (loss, ref)
