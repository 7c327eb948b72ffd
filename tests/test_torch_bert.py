"""The port's BERT (``models.bert``) against the JAX package's on the same
numpy inputs and the same weights (``load_reference_params``): the
backbone, both heads, the tied MLM decoder's gradient, ``ShardedTrainer``
steps in f32 and bf16, ``InferenceSession`` over (batch, seq) buckets, and
``examples/bert_finetune.py``'s flow.

Sizes are the JAX package's tiny test config (``tests/test_models.py``):
units 32, FFN 64, 2 layers, 4 heads, vocabulary 100, dropout 0. The JAX
attention runs its XLA reference on the CPU (T < 64); the port's runs the
flash kernels' plain versions through the autograd function the card
uses. Tolerances: outputs within 1e-5 of their largest entry; f32 trainer
losses within 1e-6 and weights within 1e-5.

bf16 (``ShardedTrainer(dtype="bfloat16")``): BERT runs every product and
every elementwise op in bf16, and the two packages round in other places
(XLA's CPU bf16 ops round the tanh GELU's every step, torch's ``gelu`` once;
products and reductions in other orders). So the bound is set against
the port's own distance between its bf16 and f32 runs from the same
weights, as ``tests/test_torch_sharded.py`` sets it, with the JAX attention
on its Pallas flash kernel (interpret mode), whose f32 scores the port's
kernels share (its XLA reference rounds the scores to bf16 first):

* losses within ``LOSS_TOL`` = 1.5e-4 (measured 1.15e-4; 3.0e-4 against
  the XLA reference), checked to be at most a quarter of the bf16-f32
  distance (7.4e-4);
* the weights within ``PARAM_TOL`` = 5e-2 of how far they moved, in norm
  (measured 4.31e-2), checked to be at most the bf16-f32 distance itself
  (5.20e-2), not a quarter of it as for the Llama, where only layer 0 runs
  in bf16: here the two bf16 runs are as far apart as bf16 is from f32 at
  every quantile of the weights (median 1.3e-3 lr against 1.6e-3 lr,
  99th percentile 0.23 lr against 0.33 lr). The key projections' biases
  are left out of it: their gradient is exactly zero (a softmax does not
  move when every score of a row moves alike), so Adam moves them by lr
  times the sign of rounding noise, which carried 39% of the squared
  difference.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd
from mxnet_tpu import numpy as mnp
from mxnet_tpu.gluon.block import HybridBlock
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.ops import registry as jregistry
from mxnet_tpu.ops.pallas import flash_attention as jfa
from mxnet_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from mxnet_tpu.parallel import ShardingRules as JaxShardingRules
from mxnet_tpu.parallel import make_mesh as jax_make_mesh
from mxnet_tpu.serve import InferenceSession as JaxInferenceSession
from mxnet_tpu_torch import models
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.models import load_reference_params
from mxnet_tpu_torch.ops.hopper import flash_attention as fa
from mxnet_tpu_torch.parallel import ShardedTrainer, ShardingRules
from mxnet_tpu_torch.serve import InferenceSession

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
TINY = dict(units=32, hidden_size=64, num_layers=2, num_heads=4,
            vocab_size=100, max_length=64, dropout=0.0)
ADAM = ("adam", {"learning_rate": 1e-3})
LOSS_TOL, PARAM_TOL = 1.5e-4, 5e-2
F32, BF16 = torch.float32, torch.bfloat16


def _np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return x.detach().float().numpy() if torch.is_tensor(x) else \
        np.asarray(x)


def _close(ours, ref, tol=TOL):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(ours - ref).max())
    assert err <= tol * scale, (err, scale)


def _jax_params(block):
    return {k: v.data().asnumpy() for k, v in block.collect_params().items()}


def _head(pkg, bert, head):
    if head == "pretrain":
        return pkg.BERTForPretrain(bert)
    if head == "classifier":
        return pkg.BERTClassifier(bert, num_classes=3, dropout=0.0)
    return bert


class _JaxStep(HybridBlock):
    """The JAX package's callers' single-input wrapper (``bench.py``'s
    ``PretrainStep``, ``examples/bert_finetune.py``'s ``Step``)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, tokens):
        return self.model(tokens, valid_length=(tokens != 0).sum(axis=1))


def _pair(head, step=False, seed=0, **overrides):
    """(JAX block, port block with its weights), both built from the tiny
    config, wrapped in the single-input step with ``step``."""
    cfg = dict(TINY, **overrides)
    mx.random.seed(seed)
    j = _head(jbert, jbert.get_bert_model(**cfg), head)
    t = _head(tbert, tbert.get_bert_model(device="cpu", **cfg), head)
    if step:
        j, t = _JaxStep(j), tbert.BERTStep(t)
    j.initialize()
    with autograd.predict_mode():
        j(mnp.array(np.ones((1, 8), np.int32)))
    return j, load_reference_params(t, _jax_params(j))


def _inputs(seed=1, b=3, t=16, vocab=100):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (b, t)).astype(np.int32)
    types = rng.randint(0, 2, (b, t)).astype(np.int32)
    vl = np.array([t, t // 2 + 1, 0][:b], np.int32)
    return ids, types, vl


@pytest.mark.parametrize("head", ["model", "pretrain", "classifier"])
def test_bert_forward_matches_jax(head):
    """``BERTModel`` (sequence and pooled outputs), ``BERTForPretrain``
    (MLM and NSP scores) and ``BERTClassifier``, with token types and
    ``valid_length`` (one row 0: every key masked, no NaN)."""
    j, t = _pair(head)
    ids, types, vl = _inputs()
    with autograd.predict_mode():
        ref = j(mnp.array(ids), mnp.array(types), mnp.array(vl))
    with torch.no_grad():
        out = t(torch.from_numpy(ids), torch.from_numpy(types),
                torch.from_numpy(vl))
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        _close(o, r)
        assert bool(torch.isfinite(o).all())
    assert fa.last_path() == "torch"


def test_bert_valid_length_masks_padding():
    """Tokens past ``valid_length`` do not move the valid positions."""
    _, t = _pair("model")
    ids, _, _ = _inputs(b=1, t=8)
    vl = torch.tensor([5])
    with torch.no_grad():
        a, _ = t(torch.from_numpy(ids), None, vl)
        ids2 = ids.copy()
        ids2[0, 5:] = 1
        b, _ = t(torch.from_numpy(ids2), None, vl)
    torch.testing.assert_close(a[0, :5], b[0, :5], rtol=1e-6, atol=1e-6)


def test_bert_pretrain_backward_ties_embedding():
    """The MLM decoder is the word embedding's own parameter: one gradient,
    the sum of both uses, equal to the JAX package's; and
    ``torch.func.functional_call`` (the trainer's cast-for-compute) keeps
    the tie, so the same gradient reaches the one entry of its params
    dict."""
    j, t = _pair("pretrain")
    ids, _, vl = _inputs(2)
    with autograd.record():
        mlm, nsp = j(mnp.array(ids), None, mnp.array(vl))
        loss = mlm.sum() + nsp.sum()
    loss.backward()
    ref = j.collect_params()["bert.word_embed.weight"].grad().asnumpy()
    mlm_t, nsp_t = t(torch.from_numpy(ids), None, torch.from_numpy(vl))
    assert tuple(mlm_t.shape) == (3, 16, 100) and tuple(nsp_t.shape) == (3, 2)
    (mlm_t.sum() + nsp_t.sum()).backward()
    grad = t.bert.word_embed.weight.grad
    _close(grad, ref)
    names = [n for n, _ in t.named_parameters()]
    assert names.count("bert.word_embed.weight") == 1
    assert not any("decoder" in n for n in names)
    # only the embedding's use: the decoder adds a gradient of its own
    t.zero_grad()
    seq, _ = t.bert(torch.from_numpy(ids), None, torch.from_numpy(vl))
    seq.sum().backward()
    assert float((grad - t.bert.word_embed.weight.grad).abs().max()) > 1e-3
    params = {n: p.detach().clone().requires_grad_()
              for n, p in t.named_parameters()}
    m2, n2 = torch.func.functional_call(
        t, params, (torch.from_numpy(ids), None, torch.from_numpy(vl)))
    (m2.sum() + n2.sum()).backward()
    _close(params["bert.word_embed.weight"].grad, ref)


def test_bert_config_registry_and_sharding_rules():
    with pytest.raises(MXNetError, match="unknown bert config"):
        tbert.get_bert_model("bert_nonexistent", device="cpu")
    with pytest.raises(MXNetError, match="pretrained"):
        tbert.get_bert_model(pretrained=True, device="cpu")
    assert tbert._BERT_CONFIGS == jbert._BERT_CONFIGS
    rules, ref = tbert.bert_sharding_rules(), jbert.bert_sharding_rules()
    assert [r[0] for r in rules] == [r[0] for r in ref]
    assert [tuple(r[1]) for r in rules] == [tuple(r[1]) for r in ref]
    assert ShardingRules(rules).rules == rules
    jmod = __import__("mxnet_tpu.models", fromlist=["x"])
    public = [n for n in dir(jmod) if not n.startswith("_")
              and "llama" not in n.lower()]
    assert not [n for n in public if not hasattr(models, n)], public


# -- training ---------------------------------------------------------------


def _batch(b=4, t=16, vocab=100, seed=3):
    """bench.py's ``_bert_setup`` data at the tiny size: tokens from
    1..vocab-1 with every other row's last quarter padded, random MLM and
    NSP labels."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, vocab, (b, t)).astype(np.int32)
    tokens[::2, t - t // 4:] = 0
    mlm = rng.randint(1, vocab, (b, t)).astype(np.int32)
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return tokens, mlm, nsp


def _loss_fn(ce):
    def loss_fn(outs, labels):
        mlm_scores, nsp_scores = outs
        mlm_labels, nsp_labels = labels
        return ce(mlm_scores, mlm_labels).mean() + \
            ce(nsp_scores, nsp_labels).mean()
    return loss_fn


def _jax_pretrain(dtype, steps=3, flash=False):
    """The JAX ``ShardedTrainer`` on the wrapped ``BERTForPretrain``: the
    initial weights, per-step losses, final weights and the (q, k, v)
    dtypes its attention saw while the step traced. ``flash``: its
    attention on the Pallas kernels in interpret mode."""
    j, _ = _pair("pretrain", step=True)
    init = _jax_params(j)
    tokens, mlm, nsp = _batch()
    seen, orig = [], jfa.attention

    def spy(q, k, v, *args, **kw):
        seen.append(tuple(str(a.dtype) for a in (q, k, v)))
        return orig(q, k, v, *args, **kw)

    jfa.attention = spy
    jregistry.set_eager_jit(False)      # trace every op, so spy sees it
    if flash:
        jfa.use_interpret(True)
        jfa.force_path("pallas")
    try:
        tr = JaxShardedTrainer(
            j, _loss_fn(mx.gluon.loss.SoftmaxCrossEntropyLoss()), ADAM[0],
            dict(ADAM[1]), mesh=jax_make_mesh({"dp": 1}), dtype=dtype)
        losses = [float(tr.step(tokens, (mlm, nsp)).asnumpy())
                  for _ in range(steps)]
        assert jfa.last_path() == ("pallas" if flash else "xla")
    finally:
        jfa.force_path(None)
        jfa.use_interpret(False)
        jregistry.set_eager_jit(True)
        jfa.attention = orig
    return init, losses, {n: np.asarray(a) for n, a in tr.params.items()}, \
        seen


def _port_pretrain(init, dtype, steps=3):
    _, t = _pair("pretrain", step=True)
    load_reference_params(t, init)
    tokens, mlm, nsp = (torch.from_numpy(a).long() for a in _batch())
    seen, orig = [], fa._FlashCore.forward

    def spy(ctx, q, k, v, *args):
        seen.append((q.dtype, k.dtype, v.dtype))
        return orig(ctx, q, k, v, *args)

    fa._FlashCore.forward = staticmethod(spy)
    try:
        tr = ShardedTrainer(t, _loss_fn(tloss.SoftmaxCrossEntropyLoss()),
                            *ADAM, dtype=dtype)
        losses = [float(tr.step(tokens, (mlm, nsp))) for _ in range(steps)]
    finally:
        fa._FlashCore.forward = staticmethod(orig)
    return losses, {n: p.detach().numpy()
                    for n, p in t.named_parameters()}, seen


def _rel(a, b, init):
    """Norm of a - b over the norm of how far a moved from init, without
    the key projections' biases (exact zero gradients: see the module
    docstring)."""
    names = [n for n in a if "key_proj.bias" not in n]
    diff = sum(float(((a[n] - b[n]).astype(np.float64) ** 2).sum())
               for n in names)
    moved = sum(float(((a[n] - init[n]).astype(np.float64) ** 2).sum())
                for n in names)
    return (diff / moved) ** 0.5


_RUNS = {}


def _runs():
    """JAX f32 and bf16 runs and the port's from the same weights, made
    once for the two tests below."""
    if not _RUNS:
        init, ref_losses, ref_params, _ = _jax_pretrain(None)
        _, bf_losses, bf_params, bf_seen = _jax_pretrain("bfloat16",
                                                         flash=True)
        _RUNS.update(init=init, f32=(ref_losses, ref_params),
                     bf16=(bf_losses, bf_params, bf_seen),
                     port_f32=_port_pretrain(init, None),
                     port_bf16=_port_pretrain(init, "bfloat16"))
    return _RUNS


def test_sharded_trainer_f32_matches_jax():
    """Three Adam steps of the wrapped ``BERTForPretrain`` with bench.py's
    loss: losses within 1e-6, every weight within 1e-5."""
    runs = _runs()
    ref_losses, ref_params = runs["f32"]
    losses, params, seen = runs["port_f32"]
    np.testing.assert_allclose(losses, ref_losses, atol=1e-6, rtol=0)
    assert losses[2] < losses[0]
    assert sorted(params) == sorted(ref_params)
    for name, p in params.items():
        np.testing.assert_allclose(p, ref_params[name], atol=1e-5, rtol=0,
                                   err_msg=name)
    assert seen == [(F32, F32, F32)] * 6      # 2 layers x 3 steps


def test_sharded_trainer_bf16_matches_jax():
    """``dtype="bfloat16"``: BERT has no f32 table after the embeddings
    (its positions are a learned parameter, cast like every other), so q,
    k and v reach attention in (bf16, bf16, bf16) in every layer, in the
    JAX trainer's trace and in the port (the (bf16, bf16) instantiation of
    the flash kernels on the card)."""
    runs = _runs()
    init = runs["init"]
    ref_losses, ref_params, ref_seen = runs["bf16"]
    losses, params, seen = runs["port_bf16"]
    f32_losses, f32_params, _ = runs["port_f32"]
    assert ref_seen == [("bfloat16",) * 3] * 2, ref_seen
    assert seen == [(BF16, BF16, BF16)] * 6, seen
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
    loss_diff = max(abs(a - b) for a, b in zip(losses, ref_losses))
    loss_gap = max(abs(a - b) for a, b in zip(losses, f32_losses))
    rel = _rel(params, ref_params, init)
    rel_gap = _rel(params, f32_params, init)
    assert loss_diff <= LOSS_TOL <= loss_gap / 4, (loss_diff, loss_gap)
    assert rel <= PARAM_TOL <= rel_gap, (rel, rel_gap)
    for name, p in params.items():
        assert p.dtype == np.float32, name


def test_sharded_trainer_runs_dropout_in_train_mode():
    """The step runs the block in training mode, as the JAX trainer traces
    it (``train_mode=True``), and gives the block its own mode back: with
    dropout 0.5 the same batch gives other losses step to step, while
    ``eval()`` forwards stay deterministic."""
    _, t = _pair("classifier", step=True, dropout=0.5)
    t.eval()
    tokens = torch.from_numpy(_batch()[0]).long()
    with torch.no_grad():
        a, b = t(tokens), t(tokens)
    assert torch.equal(a, b)
    tr = ShardedTrainer(t, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                        {"learning_rate": 0.0})
    losses = [float(tr.step(tokens, torch.zeros(4).long()))
              for _ in range(3)]
    assert len(set(losses)) == 3, losses
    assert not any(m.training for m in t.modules())
    with torch.no_grad():
        assert torch.equal(t(tokens), a)


def test_step_n_over_tuple_labels_equals_steps():
    """bench.py's labels are a tuple (MLM, NSP): ``step_n`` slices every
    leaf of a stacked batch, as the JAX package slices its pytree leaves.
    With dropout 0.1 and the port's stream reseeded, a window of three
    gives three ``step()`` calls' losses and weights (f32, within 1e-6: the
    same ops on the same inputs; a label taken from the wrong leaf or
    another dropout mask moves the loss by far more)."""
    from mxnet_tpu_torch import random as trandom

    tokens, mlm, nsp = (torch.from_numpy(a).long() for a in _batch())
    runs = []
    for windowed in (False, True):
        _, t = _pair("pretrain", step=True, dropout=0.1)
        trandom.seed(5)
        tr = ShardedTrainer(t, _loss_fn(tloss.SoftmaxCrossEntropyLoss()),
                            *ADAM)
        if windowed:
            losses = tr.step_n(tokens.expand(3, -1, -1),
                               (mlm.expand(3, -1, -1), nsp.expand(3, -1)))
        else:
            losses = torch.stack([tr.step(tokens, (mlm, nsp))
                                  for _ in range(3)])
        runs.append((losses, [p.detach().clone() for p in t.parameters()]))
    torch.testing.assert_close(runs[0][0], runs[1][0], atol=1e-6, rtol=0)
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


# -- serving ----------------------------------------------------------------


def test_inference_session_matches_jax():
    """The wrapped classifier served over (batch, seq) buckets with pad
    value 0, against the JAX session (``deterministic=False``: the
    installed JAX refuses the deterministic compiler options). Requests of
    1 x 5, 3 x 12 (one row all padding: ``valid_length`` 0) and 4 x 16
    tokens; the same warm signature set, none new after warmup."""
    j, t = _pair("classifier", step=True)
    t.eval()
    kw = dict(batch_buckets=(1, 4), seq_buckets=(8, 16), pad_value=0)
    jsess = JaxInferenceSession(j, deterministic=False, **kw)
    sess = InferenceSession(t, device="cpu", **kw)
    rng = np.random.RandomState(4)
    reqs = [rng.randint(1, 100, (n, s)).astype(np.int32)
            for n, s in ((1, 5), (3, 12), (4, 16))]
    reqs[1][2] = 0
    assert sess.warmup(reqs[0]) == jsess.warmup(reqs[0]) == 4
    for r in reqs:
        out = sess.predict(r)
        ref = jsess.predict(r)
        assert tuple(out.shape) == (r.shape[0], 3)
        _close(out, ref)
        assert bool(torch.isfinite(out).all())
    sess.assert_no_recompiles()
    jsess.assert_no_recompiles()


# -- examples/bert_finetune.py ------------------------------------------------


def _finetune_example():
    spec = importlib.util.spec_from_file_location(
        "bert_finetune", ROOT / "examples" / "bert_finetune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bert_finetune_flow_matches_jax():
    """``examples/bert_finetune.py``'s flow at 2 layers and the tiny
    widths: its synthetic batch (padded tails), the single-input wrapper
    over ``BERTClassifier``, ``ShardedTrainer`` with Adam at 3e-4 and
    ``ShardingRules(default_axis=None)``, four steps, in f32: the losses
    equal the JAX run's to 1e-6 and fall."""
    ex = _finetune_example()
    x, y = ex.synthetic_batch(np.random.RandomState(0), 8, 16, 100, 2)
    j, t = _pair("classifier", step=True)
    opt = ("adam", {"learning_rate": 3e-4})
    jt = JaxShardedTrainer(j, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                           opt[0], dict(opt[1]),
                           mesh=jax_make_mesh({"dp": 1}),
                           rules=JaxShardingRules(default_axis=None))
    ref = [float(jt.step(x, y).asnumpy()) for _ in range(4)]
    tt = ShardedTrainer(t, tloss.SoftmaxCrossEntropyLoss(), *opt,
                        rules=ShardingRules(default_axis=None))
    got = [float(tt.step(torch.from_numpy(x).long(),
                         torch.from_numpy(y).long())) for _ in range(4)]
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert got[-1] < got[0]
