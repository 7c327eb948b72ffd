"""``ShardedTrainer`` on one device (the one-device part of
``mxnet_tpu/parallel/functional.py``).

In the JAX package the whole training step (forward, backward and every
parameter's update) is one compiled SPMD program over a device mesh. Here
it is the same sequence in eager PyTorch on one GPU: the f32 masters are
the module's own parameters, each updated in place by the optimizer's
rule (``_prep_grad``, then ``_update_raw``), and the loss is the f32 mean
of ``loss_fn``'s output.

Mixed precision (``dtype="bfloat16"`` or ``"float16"``), as in the JAX
package:

* cast-for-compute: the block runs on low-precision copies of its
  floating parameters and inputs (``torch.func.functional_call``); the
  gradients flow back through the casts to the f32 masters;
* inner AMP, for a block with ``supports_inner_amp`` and ``remat=True``
  (``models.llama.LlamaModel``): only the inputs are cast, and the block
  casts each recomputed layer's parameters at use, so no low-precision
  copy of the weights lives across the step.

Under cast-for-compute the block's mutable state (the floating buffers
that a ``state_dict`` keeps: BatchNorm's running statistics) goes through
the step as the JAX package carries it: it enters as compute-dtype copies
and what the step leaves in them comes back to the f32 buffers, so the
running statistics are rounded to the compute dtype once a step. (The
JAX step casts its state with its parameters and returns the new state
at the master dtype.)

The step runs the block in training mode (Dropout active, BatchNorm on
batch statistics), whatever mode it is in between steps, as the JAX
package's step traces it with ``train_mode=True``.

Ported so far: one device, ``step``, ``step_n``, ``step_flops`` and
``step_cost_analysis``. ``parallel=``, ``zero_bucket_mb > 0``,
``abstract=True``, a pipelined block and a mesh of more than one device
raise; checkpoints, ``export_state`` and the elastic hooks are ROADMAP
A.4.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..base import MXNetError
from ..optimizer import create as create_optimizer
from ..resilience import faults as _faults
from . import mesh as mesh_mod

_AMP = {"bfloat16": torch.bfloat16, "float16": torch.float16,
        torch.bfloat16: torch.bfloat16, torch.float16: torch.float16}


class ShardingRules:
    """Name-compatible stand-in for the JAX package's ``(regex,
    PartitionSpec)`` table. On one device every parameter is whole, so the
    rules are kept and never applied."""

    def __init__(self, rules=(), default_axis="fsdp"):
        self.rules = list(rules)
        self.default_axis = default_axis


def _collect_aux_losses(block):
    """Sum of the ``aux_loss`` tensors the forward just set on any
    submodule (MoE router balance terms), or None."""
    total = None
    for m in block.modules():
        aux = getattr(m, "aux_loss", None)
        if isinstance(aux, torch.Tensor):
            total = aux if total is None else total + aux
    return total


def _first_leaf(tree):
    while isinstance(tree, (list, tuple)):
        tree = tree[0]
    return tree


def _leaf_step(tree, j):
    """Step ``j`` of every leaf of a batch stacked on a leading axis."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaf_step(x, j) for x in tree)
    return tree[j]


def _cast(x, dtype):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


def _signature(tree):
    """Shapes and dtypes of a batch's leaves: the key ``step_flops`` is
    counted under."""
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return type(tree).__name__


class _FlopCount(TorchDispatchMode):
    """A dispatch mode that sums, in ``total``, the floating-point
    operations of the ops run under it, by PyTorch's own formulas
    (``torch.utils.flop_counter.flop_registry``: products and
    convolutions, forward and backward). ``FlopCounterMode`` itself is not
    used: it runs ops through their decompositions and hooks every
    module's backward, which changes the step's last bits."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


@contextlib.contextmanager
def _state_in(block, dtype):
    """Hand every module of ``block`` compute-dtype copies of its floating
    persistent buffers for the forward, and write what the forward left
    in them (a new tensor the module put in their place, or the copy
    itself) back to the original buffers, in their own dtype. The
    originals stay where they are: nothing holding them is disturbed."""
    swapped = []
    try:
        for mod in block.modules():
            for name, buf in mod._buffers.items():
                if (buf is not None and buf.is_floating_point()
                        and name not in mod._non_persistent_buffers_set):
                    swapped.append((mod, name, buf))
        for mod, name, buf in swapped:
            mod._buffers[name] = buf.to(dtype)
        yield
        with torch.no_grad():
            for mod, name, buf in swapped:
                buf.copy_(mod._buffers[name])
    finally:
        for mod, name, buf in swapped:
            mod._buffers[name] = buf


class ShardedTrainer:
    """``ShardedTrainer(block, loss_fn, optimizer, optimizer_params=None,
    mesh=None, rules=None, batch_spec=None, dtype=None,
    aux_loss_weight=0.01)``::

        trainer = ShardedTrainer(model, SoftmaxCrossEntropyLoss(), "adam",
                                 {"learning_rate": 1e-4}, dtype="bfloat16")
        loss = trainer.step(tokens, labels)      # f32 scalar tensor
        losses = trainer.step_n(tok_n, lab_n)    # (n,): n stacked batches

    ``block`` is a ``torch.nn.Module`` whose parameters that require
    gradients are trained; ``loss_fn(out, labels)`` gives per-sample
    losses, averaged in f32.
    """

    def __init__(self, block, loss_fn, optimizer, optimizer_params=None,
                 mesh=None, rules=None, batch_spec=None, dtype=None,
                 aux_loss_weight=0.01, abstract=False, zero_bucket_mb=None,
                 parallel=None):
        if parallel is not None:
            raise MXNetError("ShardedTrainer(parallel=...): tensor and "
                             "pipeline parallelism are ROADMAP A.4")
        if zero_bucket_mb and float(zero_bucket_mb) > 0:
            raise MXNetError("ShardedTrainer(zero_bucket_mb=...): ZeRO "
                             "buckets are ROADMAP A.4")
        if abstract:
            raise MXNetError("ShardedTrainer(abstract=True): compile-only "
                             "lowering is ROADMAP A.4")
        if hasattr(block, "_pp_functionalize"):
            raise MXNetError("ShardedTrainer: pipelined blocks are ROADMAP "
                             "A.4")
        if dtype is not None and dtype not in _AMP:
            raise MXNetError(f"ShardedTrainer dtype must be None, bfloat16 "
                             f"or float16, got {dtype!r}")
        self.block = block
        self.loss_fn = loss_fn
        self.optimizer = (create_optimizer(optimizer,
                                           **(optimizer_params or {}))
                          if isinstance(optimizer, str) else optimizer)
        named = list(block.named_parameters())
        if not named:
            raise MXNetError("ShardedTrainer: the block has no parameters")
        device = named[0][1].device
        self.mesh = (mesh if mesh is not None
                     else mesh_mod.make_mesh(devices=[device]))
        if self.mesh.size != 1:
            raise MXNetError("ShardedTrainer: meshes of several devices are "
                             "ROADMAP A.4")
        if self.mesh.device != device:
            raise MXNetError(f"ShardedTrainer: the block lives on {device}, "
                             f"the mesh on {self.mesh.device}")
        self.rules = rules if rules is not None else ShardingRules()
        self.batch_spec = batch_spec
        self._dtype = None if dtype is None else _AMP[dtype]
        self._aux_weight = aux_loss_weight
        # the f32 masters are the block's own parameters; those that do
        # not require gradients stay as they are
        self.params = dict(named)
        self._train = [p for _, p in named if p.requires_grad]
        self.optimizer.param_dict = dict(enumerate(self._train))
        with torch.no_grad():
            self._opt_states = [self.optimizer.create_state(i, p.detach())
                                for i, p in enumerate(self._train)]
        self._step_count = 0
        self._flops = {}
        self._step_flops = None

    # -- the step ---------------------------------------------------------
    @property
    def _inner_amp(self):
        return (self._dtype is not None
                and getattr(self.block, "supports_inner_amp", False)
                and getattr(self.block, "_remat", False))

    @contextlib.contextmanager
    def _protocol(self):
        """Tell a block with the inner-AMP protocol that a step runs (its
        recompute loop) and under which dtype, for this step only."""
        if not getattr(self.block, "supports_inner_amp", False):
            yield
            return
        prev = (self.block._amp_dtype, self.block._in_step)
        self.block._amp_dtype = self._dtype if self._inner_amp else None
        self.block._in_step = True
        try:
            yield
        finally:
            self.block._amp_dtype, self.block._in_step = prev

    @contextlib.contextmanager
    def _train_mode(self):
        """Run the step with every submodule in training mode (Dropout
        active), as the JAX package traces its step with
        ``functionalize(block, train_mode=True)``; each submodule's own
        mode comes back afterwards. It covers the backward too, so a layer
        recomputed there (``remat``) runs in the same mode."""
        modes = [(m, m.training) for m in self.block.modules()]
        self.block.train()
        try:
            yield
        finally:
            for m, training in modes:
                m.training = training

    def _loss(self, data, labels):
        amp = self._dtype
        batch = tuple(data) if isinstance(data, (list, tuple)) else (data,)
        if amp is not None:
            batch = tuple(_cast(x, amp) for x in batch)
        with self._protocol():
            if amp is not None and not self._inner_amp:
                # cast-for-compute: the backward through the casts hands
                # f32 gradients to the f32 masters; the state is cast too
                params = {n: _cast(p, amp) for n, p in self.params.items()}
                with _state_in(self.block, amp):
                    out = torch.func.functional_call(self.block, params,
                                                     batch)
            else:
                out = self.block(*batch)
            loss = self.loss_fn(out, labels)
            aux = _collect_aux_losses(self.block)
        if aux is not None:
            loss = loss + self._aux_weight * aux
        return torch.mean(loss.to(torch.float32))

    def _step_once(self, data, labels, lrs, wds, t):
        sig = (_signature(data), _signature(labels))
        if sig in self._flops:
            loss = self._run_step(data, labels, lrs, wds, t)
        else:
            counter = _FlopCount()
            with counter:
                loss = self._run_step(data, labels, lrs, wds, t)
            self._flops[sig] = counter.total
        self._step_flops = self._flops[sig]
        return loss

    def _run_step(self, data, labels, lrs, wds, t):
        for p in self._train:
            p.grad = None
        with self._train_mode():
            loss = self._loss(data, labels)
            loss.backward()
        opt = self.optimizer
        with torch.no_grad():
            for i, p in enumerate(self._train):
                # a parameter the loss does not reach has a zero gradient,
                # as jax.grad gives it
                g = (torch.zeros_like(p) if p.grad is None
                     else p.grad.to(p.dtype))
                p.grad = None
                opt._update_raw(p, opt._prep_grad(g), self._opt_states[i],
                                lrs[i], wds[i], t)
        return loss.detach()

    def _advance_optimizer(self, n):
        """Advance the step and update counts by n; return (lrs, wds,
        t_first)."""
        t_first = self._step_count + 1
        self._step_count += n
        n_train = len(self._train)
        for i in range(n_train):
            self.optimizer._index_update_count[i] = self._step_count
        lrs = tuple(self.optimizer._get_lr(i) for i in range(n_train))
        wds = tuple(self.optimizer._get_wd(i) for i in range(n_train))
        return lrs, wds, t_first

    def step(self, data, labels):
        """One training step; returns the f32 mean loss (a 0-d tensor on
        the block's device). ``data`` may be one tensor or a tuple."""
        _faults.fault_point("trainer:sharded_step",
                            {"step": self._step_count})
        lrs, wds, t = self._advance_optimizer(1)
        return self._step_once(data, labels, lrs, wds, t)

    def step_n(self, data, labels, num_steps=None):
        """``num_steps`` training steps over batches stacked on a leading
        axis (``(num_steps, B, ...)``; default: all of it). ``data`` and
        ``labels`` may be tensors or tuples and lists of them (the JAX
        package's pytree leaves), each leaf stacked. The learning rate and
        weight decay are held across the window. Returns the per-step
        losses, shape (num_steps,)."""
        avail = _first_leaf(data).shape[0]
        n = avail if num_steps is None else int(num_steps)
        if n < 1 or n > avail:
            raise MXNetError(
                f"step_n: num_steps={num_steps} but the stacked leading "
                f"axis holds {avail} step batches")
        lrs, wds, t0 = self._advance_optimizer(n)
        losses = []
        for j in range(n):
            losses.append(self._step_once(_leaf_step(data, j),
                                          _leaf_step(labels, j), lrs, wds,
                                          t0 + j))
        return torch.stack(losses)

    @property
    def step_flops(self):
        """Floating-point operations of one step of the last signature run
        (forward, backward and update; None before the first step): the
        MFU numerator. Counted once per batch signature (shapes and
        dtypes), while that signature's first step runs, by PyTorch's flop
        formulas (:class:`_FlopCount`), and cached, so later steps pay
        nothing for it; a ``step_n`` window reports one step's.

        It counts the products the step dispatches to PyTorch: matrix
        products and convolutions, forward and backward, at 2 per
        multiply-add. XLA's cost analysis, the JAX package's figure, also
        counts elementwise operations (normalizations, activations, the
        optimizer's update), so this count is lower; and a product inside
        a kernel of ``ops.hopper`` (the flash attention) is not seen."""
        return self._step_flops

    @property
    def step_cost_analysis(self):
        """``{"flops": step_flops}`` of the last step ({} before the first
        step): the one figure of XLA's cost analysis this trainer
        measures."""
        if self._step_flops is None:
            return {}
        return {"flops": self._step_flops}

    def sync_to_block(self):
        """Nothing to do: the block's parameters are the masters and hold
        the trained weights after every step. (In the JAX package the
        block keeps its old weights until this call.)"""
