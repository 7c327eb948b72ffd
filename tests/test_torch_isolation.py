"""The port stands alone: ``mxnet_tpu_torch`` and ``chip_smoke.py`` never
import JAX or the JAX package, and the port's entry points never carry on
quietly on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_ISOLATED = r"""
import sys
sys.modules["jax"] = None        # any import of jax now raises ImportError
sys.modules["mxnet_tpu"] = None
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import get_llama
from mxnet_tpu_torch.serve import Generator
mt.random.seed(0)
gen = Generator(get_llama("llama_tiny_test", device="cpu"), max_seq=32,
                batch_buckets=(2,), prompt_buckets=(8,))
out, info = gen.generate([[1, 2, 3], [4, 5]], max_new_tokens=4)
assert [len(o) for o in out] == [4, 4], out
from mxnet_tpu_torch.serve import GraphSession, PagedKVPool, PrefixCache
ms = Generator(gen.model, max_seq=32,
               batch_buckets=(2,), prompt_buckets=(8,), multistep=True,
               prefix_cache=True, page_size=8)
assert ms.generate([[1, 2, 3], [4, 5]], max_new_tokens=4)[0] == out
assert not ms._msession.graphs and ms._fresh_cache(2).device.type == "cpu"
import torch
from mxnet_tpu_torch import gluon, lr_scheduler, optimizer
from mxnet_tpu_torch.ops.hopper import flash_attention
model = get_llama("llama_tiny_test", device="cpu", trainable=True)
tr = gluon.Trainer(model.parameters(), "adamw",
                   {"learning_rate": 1e-3,
                    "lr_scheduler": lr_scheduler.FactorScheduler(2)})
toks = torch.randint(0, 256, (2, 9))
loss = gluon.loss.SoftmaxCrossEntropyLoss()(model(toks[:, :-1]), toks[:, 1:])
loss.sum().backward()
tr.step(2)
assert flash_attention.last_path() == "torch"
assert isinstance(tr.optimizer, optimizer.AdamW)
from mxnet_tpu_torch.contrib.pallas_fuse import fuse_resnet_v1
from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
from mxnet_tpu_torch.ops.hopper import conv1x1
from mxnet_tpu_torch.serve import InferenceSession
sess = InferenceSession(fuse_resnet_v1(get_resnet(1, 50, device="cpu"),
                                       use_pallas=True), batch_buckets=(2,))
assert tuple(sess.predict(torch.rand(1, 3, 32, 32)).shape) == (1, 1000)
assert conv1x1.last_path() == "torch"
from mxnet_tpu_torch import profiler, resilience
from mxnet_tpu_torch.serve import (ContinuousEngine, DynamicBatcher,
                                   ServeMetrics, batcher, metrics, scheduler)
for multistep in (False, True):
    with ContinuousEngine(gen.model, max_seq=32, num_slots=2, page_size=8,
                          multistep=multistep, decode_steps=2) as eng:
        got = [f.result(60)["tokens"] for f in
               [eng.submit(p, max_new_tokens=4) for p in ([1, 2, 3], [4, 5])]]
        assert got == out, (got, out)
        assert eng.pool.device.type == "cpu"
with DynamicBatcher(lambda xs: [x + 1 for x in xs], max_batch_size=2) as b:
    assert b.submit(1).result(10) == 2
assert ServeMetrics("iso").snapshot()["requests"] == 0
from mxnet_tpu_torch import serve_load
assert serve_load.traffic(4, 2.0, 256)[0][2] == 48
from mxnet_tpu_torch.serve import (ModelRegistry, Replica, Router,
                                   SpeculativeGenerator)
for multistep in (False, True):
    sg = SpeculativeGenerator(gen.model, gen.model, k=2, max_seq=32,
                              batch_buckets=(2,), prompt_buckets=(8,),
                              multistep=multistep)
    assert sg.generate([[1, 2, 3], [4, 5]], max_new_tokens=4)[0] == out
with ModelRegistry(max_models=1, max_seq=32, num_slots=2,
                   page_size=8) as reg:
    assert reg.submit("a", [1, 2, 3], max_new_tokens=4).result(60)[
        "tokens"] == out[0] if reg.load("a", model=gen.model) else False
with Router([Replica(lambda xs: [x * 2 for x in xs], index=0,
                     device="cpu")], probe_ms=0.0) as router:
    assert router.submit(3).result(10) == 6
from mxnet_tpu_torch.profiler import export, slo
from mxnet_tpu_torch.resilience import elastic, retry
assert "recorder.dumps" in export.snapshot()
assert retry.run_with_watchdog(lambda: 5, 1.0) == 5
assert slo.SLO("goodput", 0.9).budget > 0
assert not elastic.StragglerMonitor().flagged(0)
resilience.install_plan({"rules": [{"site": "x", "kind": "fatal", "at": [5]}]})
resilience.clear_plan()
tr = profiler.trace
tr.enable(); assert tr.start_trace("iso") is not None; tr.disable()
from mxnet_tpu_torch import amp, parallel
remat = get_llama("llama_tiny_test", device="cpu", trainable=True, remat=True)
st = parallel.ShardedTrainer(remat, gluon.loss.SoftmaxCrossEntropyLoss(),
                             "adam", {"learning_rate": 1e-3},
                             dtype="bfloat16")
assert float(st.step(toks[:, :-1], toks[:, 1:])) > 0
assert st.step_n(toks[None, :, :-1].repeat(2, 1, 1),
                 toks[None, :, 1:].repeat(2, 1, 1)).shape == (2,)
assert st.mesh.device.type == "cpu"
scaler = amp.LossScaler(init_scale=4.0)
tr2 = gluon.Trainer(model.parameters(), "sgd", loss_scaler=scaler)
assert float(tr2.scale_loss(torch.tensor(1.0))) == 4.0
from mxnet_tpu_torch.models import (BERTClassifier, BERTStep, Transformer,
                                    get_bert_model)
bert = BERTStep(BERTClassifier(get_bert_model(
    units=32, hidden_size=64, num_layers=2, num_heads=4, vocab_size=100,
    max_length=32, device="cpu"), num_classes=2)).eval()
bsess = InferenceSession(bert, batch_buckets=(2,), seq_buckets=(8,))
assert tuple(bsess.predict(torch.tensor([[5, 6, 0]])).shape) == (1, 2)
mt_model = Transformer(50, units=32, hidden_size=64, num_heads=4,
                       num_encoder_layers=1, num_decoder_layers=1,
                       device="cpu")
assert tuple(mt_model(toks[:, :5] % 50, toks[:, :4] % 50).shape) == (2, 4, 50)
assert not any(m == "jax" or m.startswith(("jax.", "mxnet_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ISOLATED_OK")
"""


def test_port_imports_and_generates_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED_OK" in proc.stdout


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports_in_port_sources():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "mxnet_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_entry_points_refuse_cpu_without_asking(monkeypatch):
    """With no GPU and no explicit device="cpu", the port raises."""
    from mxnet_tpu_torch import device as tdevice
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from mxnet_tpu_torch.models import get_llama
    from mxnet_tpu_torch.serve import (ContinuousEngine, DynamicBatcher,
                                       GraphSession, ServeMetrics)
    from mxnet_tpu_torch import profiler, resilience

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        get_llama("llama_tiny_test")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        get_llama("llama_tiny_test", trainable=True)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        get_resnet(1, 50)
    from mxnet_tpu_torch.models import Transformer, get_bert_model
    with pytest.raises(MXNetError, match="CUDA is not available"):
        get_bert_model(num_layers=1)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        Transformer(50, num_encoder_layers=1, num_decoder_layers=1)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tdevice.resolve(None)
    from mxnet_tpu_torch import parallel
    with pytest.raises(MXNetError, match="CUDA is not available"):
        parallel.make_mesh()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        GraphSession("g", None)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        ContinuousEngine(get_llama("llama_tiny_test"), max_seq=32)
    from mxnet_tpu_torch import serve_load
    assert serve_load.main(["--requests", "4"]) == 2
    # asked for the CPU: the engine, its batcher and metrics, the profiler
    # and fault injection run without CUDA (the last four are host-only)
    eng = ContinuousEngine(get_llama("llama_tiny_test", device="cpu"),
                           max_seq=32, num_slots=2, page_size=8,
                           multistep=True, decode_steps=2)
    try:
        eng.warmup()
        assert eng.pool.device.type == "cpu" and not eng._msession.graphs
    finally:
        eng.close()
    with DynamicBatcher(lambda xs: xs, max_batch_size=1) as b:
        assert b.submit(3).result(10) == 3
    assert ServeMetrics("refuse").snapshot()["tokens"] == 0
    plan = resilience.install_plan(
        {"rules": [{"site": "serve:decode", "kind": "fatal", "at": [9]}]})
    resilience.clear_plan()
    assert plan.stats()[0]["hits"] == 0
    assert profiler.trace.start_trace("off") is None
    assert tdevice.resolve("cpu") == torch.device("cpu")
    with pytest.raises(MXNetError, match="unsupported device"):
        tdevice.resolve("meta")


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result without CUDA."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_trainer_keeps_parameters_where_they_are():
    """``Trainer`` works on whatever device its parameters are on and never
    moves them: the same tensors, storage and device after a step, with
    their optimizer states beside them; a trainable model is in train
    mode, a serving one in eval mode without gradients."""
    from mxnet_tpu_torch.gluon import Trainer, loss
    from mxnet_tpu_torch.models import get_llama

    model = get_llama("llama_tiny_test", device="cpu", trainable=True)
    assert model.training and all(p.requires_grad
                                  for p in model.parameters())
    serving = get_llama("llama_tiny_test", device="cpu")
    assert not serving.training and not any(p.requires_grad
                                            for p in serving.parameters())
    before = [(p, p.data_ptr(), p.device) for p in model.parameters()]
    tr = Trainer(model.parameters(), "sgd", {"learning_rate": 0.1,
                                             "momentum": 0.9})
    toks = torch.randint(0, 256, (2, 9))
    out = loss.SoftmaxCrossEntropyLoss()(model(toks[:, :-1]), toks[:, 1:])
    out.sum().backward()
    tr.step(2)
    after = list(model.parameters())
    assert all(a is p and a.data_ptr() == ptr and a.device == dev
               for (p, ptr, dev), a in zip(before, after))
    assert all(s.device == p.device for p, st in zip(after, tr._states)
               for s in st)


_TRAINING = r"""
import sys
sys.modules["jax"] = None
sys.modules["mxnet_tpu"] = None
import torch
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import initializer, optimizer, parallel
from mxnet_tpu_torch.gluon import Trainer, loss, metric
from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
model = get_resnet(1, 18, device="cpu", trainable=True, classes=10,
                   thumbnail=True)
assert model.training and all(p.requires_grad for p in model.parameters())
initializer.initialize(model, "xavier")
x, y = torch.rand(2, 3, 16, 16), torch.tensor([1, 7])
for dtype in (None, "bfloat16"):
    st = parallel.ShardedTrainer(model, loss.SoftmaxCrossEntropyLoss(), "sgd",
                                 {"learning_rate": 0.1, "momentum": 0.9},
                                 dtype=dtype)
    assert float(st.step(x, y)) > 0 and st.step_flops > 0
assert model.features[1][0].body[1].running_var.dtype == torch.float32
acc, top = metric.Accuracy(), metric.TopKAccuracy(5)
for name in ("nag", "rmsprop", "lamb", "sgld", "ftrl", "dcasgd"):
    tr = Trainer(model.parameters(), name, {"learning_rate": 1e-3})
    out = model(x)
    loss.SoftmaxCrossEntropyLoss()(out, y).sum().backward()
    tr.step(2)
    acc.update([y], [out]); top.update([y], [out])
assert 0 <= acc.get()[1] <= top.get()[1] <= 1
assert len(loss.CTCLoss()(torch.randn(2, 6, 5), torch.tensor([[1, 2],
                                                            [3, 0]]))) == 2
assert not any(m == "jax" or m.startswith(("jax.", "mxnet_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("TRAINING_ISOLATED_OK")
"""


def test_training_surface_runs_without_jax(monkeypatch):
    """ResNet training (both ``ShardedTrainer`` dtypes), the initializers,
    optimizers, losses and metrics import and run with JAX blocked; a
    trainable ResNet still needs ``device="cpu"`` without CUDA."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, "-c", _TRAINING], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "TRAINING_ISOLATED_OK" in proc.stdout
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        get_resnet(1, 50, trainable=True)
