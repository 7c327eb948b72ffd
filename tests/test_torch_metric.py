"""Every metric of the port's ``gluon.metric`` against the JAX package's:
``get()`` on the same predictions and labels (seeded numpy; the port's
given as tensors, f32 or bf16), over two updates, to 1e-6."""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu import np as mnp
from mxnet_tpu.gluon import metric as jmetric
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import metric as tmetric


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(2):
        probs = rng.dirichlet(np.ones(5), 8).astype(np.float32)
        out.append({
            "cls": (rng.randint(0, 5, 8).astype(np.float32), probs),
            "bin": (rng.randint(0, 2, 8).astype(np.float32),
                    rng.uniform(0, 1, 8).astype(np.float32)),
            "bin2": (rng.randint(0, 2, 8).astype(np.float32),
                     rng.dirichlet(np.ones(2), 8).astype(np.float32)),
            "reg": (rng.randn(8, 3).astype(np.float32),
                    rng.randn(8, 3).astype(np.float32)),
            "loss": (None, rng.uniform(0, 3, (8,)).astype(np.float32)),
        })
    return out


CASES = [
    ("Accuracy", {}, "cls"), ("TopKAccuracy", {"top_k": 3}, "cls"),
    ("F1", {}, "bin"), ("F1", {}, "bin2"), ("Fbeta", {"beta": 2}, "bin"),
    ("BinaryAccuracy", {"threshold": 0.4}, "bin"),
    ("MeanPairwiseDistance", {"p": 4}, "reg"),
    ("MeanCosineSimilarity", {}, "reg"), ("MCC", {}, "bin"),
    ("Perplexity", {"ignore_label": 2}, "cls"), ("MAE", {}, "reg"),
    ("MSE", {}, "reg"), ("RMSE", {}, "reg"), ("CrossEntropy", {}, "cls"),
    ("NegativeLogLikelihood", {}, "cls"), ("PearsonCorrelation", {}, "reg"),
    ("PCC", {}, "cls"), ("Loss", {}, "loss"), ("Torch", {}, "loss"),
    ("Caffe", {}, "loss"),
]


def _update(metric, labels, preds, as_tensor, bf16=False):
    def conv(a, low=False):
        if a is None or not as_tensor:
            return a if a is None or as_tensor else mnp.array(a)
        t = torch.from_numpy(a)
        return t.bfloat16() if low else t
    metric.update([conv(labels)], [conv(preds, bf16)])


@pytest.mark.parametrize("name,kwargs,kind", CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_metric_matches_jax(name, kwargs, kind):
    j = getattr(jmetric, name)(**kwargs)
    t = getattr(tmetric, name)(**kwargs)
    assert math.isnan(t.get()[1]) and math.isnan(j.get()[1])
    for batch in _batches():
        labels, preds = batch[kind]
        _update(j, labels, preds, False)
        _update(t, labels, preds, True)
    (jn, jv), (tn, tv) = j.get(), t.get()
    assert tn == jn
    assert tv == pytest.approx(jv, rel=1e-6, abs=1e-6)
    t.reset()
    assert math.isnan(t.get()[1])


def test_bf16_predictions_read_as_f32():
    """bf16 predictions: the metric sees their f32 values."""
    batch = _batches()[0]
    labels, preds = batch["reg"]
    t = tmetric.MSE()
    _update(t, labels, preds, True, bf16=True)
    rounded = torch.from_numpy(preds).bfloat16().float().numpy()
    want = float(((labels - rounded) ** 2).mean())
    assert t.get()[1] == pytest.approx(want, rel=1e-6)


def test_composite_create_custom_and_np():
    batch = _batches()[0]
    labels, preds = batch["cls"]
    jc = jmetric.create(["acc", "top_k_acc", "ce"])
    tc = tmetric.create(["acc", "top_k_acc", "ce"])
    assert isinstance(tc, tmetric.CompositeEvalMetric)
    _update(jc, labels, preds, False)
    _update(tc, labels, preds, True)
    (jn, jv), (tn, tv) = jc.get(), tc.get()
    assert tn == jn and tv == pytest.approx(jv, rel=1e-6)
    assert dict(tc.get_name_value()) == pytest.approx(
        dict(jc.get_name_value()), rel=1e-6)
    assert str(tmetric.create("acc")).startswith("EvalMetric:")

    def feval(label, pred):
        return float((pred.argmax(-1) == label).sum()), len(label)

    for make in (lambda m: m.CustomMetric(feval, name="hits"),
                 lambda m: m.np(feval, name="hits"),
                 lambda m: m.create(feval, name="hits"),
                 lambda m: m.np_metric("hits")(feval)):
        j, t = make(jmetric), make(tmetric)
        _update(j, labels, preds, False)
        _update(t, labels, preds, True)
        assert t.get() == pytest.approx(j.get()) and t.get()[0] == j.get()[0]
    for m in (tmetric, jmetric):   # registered in neither package
        with pytest.raises(Exception, match="unknown metric"):
            m.create("composite")
    for alias in ("acc", "top_k_accuracy", "ce", "pearsonr", "mae", "f1"):
        assert type(tmetric.create(alias)).__name__ == type(
            jmetric.create(alias)).__name__
    with pytest.raises(MXNetError, match="unknown metric"):
        tmetric.create("nope")
    t = tmetric.Accuracy()
    t.update_dict({"l": torch.from_numpy(labels)},
                  {"p": torch.from_numpy(preds)})
    assert t.num_inst == len(labels)

    @tmetric.register
    class Zero(tmetric.EvalMetric):
        def __init__(self):
            super().__init__("zero")

        def update(self, labels, preds):
            self.num_inst += 1

    m = tmetric.create("zero")
    m.update(None, None)
    assert m.get() == ("zero", 0.0)
