"""Neural-network ops of the ported slices, as functions on tensors.

Each mirrors its namesake in ``mxnet_tpu/ops/nn.py`` (same arguments, same
layouts, same arithmetic), so the tests can feed one set of numpy inputs
through both packages. The JAX package's ops are pure; the KV-cache writes
and the paged scatter here update the ring or pool in place (see
:func:`kv_cache_write`, :func:`paged_kv_scatter`). None of them reads a
device value on the host, so each can run inside a captured CUDA graph.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .. import random as _rng
from ..base import MXNetError
from .hopper import decode_attention as _da
from .hopper import flash_attention as _fa
from .hopper import int8_dense as _i8
from .hopper import stable_ops as _st
from .hopper.int8_dense import int8_scale


_ACTIVATIONS = {
    "relu": F.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
    # jax.nn.gelu's default is the tanh approximation, and the JAX
    # package's "gelu" is that default
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "erf_gelu": F.gelu,
}


def activation(data, act_type="relu"):
    """Elementwise activation by name, as the JAX package names them:
    ``relu`` (ResNet), ``silu`` (Llama's SwiGLU), ``tanh`` (BERT's pooler),
    ``gelu`` and ``gelu_tanh`` (the tanh approximation, ``jax.nn.gelu``'s
    default) and ``erf_gelu`` (the exact one)."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError(f"activation {act_type!r} is not ported yet "
                         f"({', '.join(sorted(_ACTIVATIONS))})")
    return fn(data)


def dense(data, weight):
    """``data @ weight.T``, ``weight`` (out, in) as Gluon's Dense keeps it.
    Mixed dtypes promote first, as ``jnp.matmul`` promotes them (bf16
    against f32 computes in f32), where ``F.linear`` would refuse them;
    same dtypes go straight to ``F.linear``."""
    dtype = torch.promote_types(data.dtype, weight.dtype)
    return F.linear(data.to(dtype), weight.to(dtype))


def rms_norm(data, gamma, axis=-1, eps=1e-6):
    """RMSNorm: ``x / sqrt(mean(x^2) + eps) * gamma`` along ``axis``, in
    the JAX package's order: the mean of squares in f32, the reciprocal
    root cast to x's dtype, then the product with gamma, which promotes
    (bf16 x with an f32 gamma gives f32) as ``jnp`` does."""
    ms = torch.mean(torch.square(data.to(torch.float32)), dim=axis,
                    keepdim=True)
    out = data * (1.0 / torch.sqrt(ms + eps)).to(data.dtype)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return out * gamma.reshape(shape)


def stable_rms_norm(data, gamma, eps=1e-6):
    """RMSNorm along the last axis (``rms_norm``'s arithmetic) whose every
    row is one fixed-order sum whatever the number of rows: the route the
    strict ``baseline`` cache path takes, so a T = 1 decode step normalizes
    a row exactly as a T = bucket prefill does. The kernel
    ``ops.hopper.stable_ops`` (S3) on CUDA tensors, its plain version on the
    CPU. (:func:`rms_norm` runs PyTorch's reductions, whose block layout on
    the card follows the number of rows.)"""
    return _st.stable_rms_norm(data, gamma, eps)


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """``x @ weight.T + bias``, ``weight`` (num_hidden, in). ``flatten=True``
    collapses every axis but the first (Gluon's default); ``flatten=False``
    applies to the last axis. Mixed dtypes promote first, as ``jnp.matmul``
    and the bias add promote them."""
    del num_hidden  # the weight's shape says it
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    b = None if no_bias else bias
    dtype = torch.promote_types(x.dtype, weight.dtype)
    if b is not None:
        dtype = torch.promote_types(dtype, b.dtype)
    return F.linear(x.to(dtype), weight.to(dtype),
                    None if b is None else b.to(dtype))


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization along ``axis``: ``(x - mean) / sqrt(var + eps)
    * gamma + beta`` with the population variance. The mean and variance
    are taken in f32 and rounded to x's dtype, as ``jnp.mean``/``jnp.var``
    take them for a bf16 or f16 ``x``; the rest runs in x's dtype and
    promotes against gamma and beta as ``jnp`` does."""
    xf = data.to(torch.float32)
    mean = xf.mean(dim=axis, keepdim=True)
    var = xf.var(dim=axis, keepdim=True, correction=0)
    out = (data - mean.to(data.dtype)) / torch.sqrt(var.to(data.dtype) + eps)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return out * gamma.reshape(shape) + beta.reshape(shape)


def dropout(data, p=0.5, axes=(), training=False, generator=None):
    """Inverted dropout: each element kept with probability ``1 - p`` and
    scaled by ``1 / (1 - p)``; ``axes`` share one draw along each axis
    named (the mask has extent 1 there). It acts only when ``training`` is
    true (the JAX op reads ``autograd.is_training()``; a module passes its
    ``training`` flag). The mask is drawn in f32 from ``generator``, by
    default the device's seeded stream (``mxnet_tpu_torch.random.generator``),
    so a run of another dtype draws the same mask. The bits are not
    threefry's."""
    if p <= 0 or not training:
        return data
    gen = generator if generator is not None else _rng.generator(
        data.device)
    shape = list(data.shape)
    for ax in axes:
        shape[ax] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=torch.float32,
                       device=data.device).bernoulli_(keep, generator=gen)
    return data * mask.to(data.dtype) / keep


def embedding(data, weight, sparse_grad=False):
    """Dense lookup of the rows ``data`` (any integer shape) of ``weight``
    (input_dim, output_dim)."""
    if sparse_grad:
        raise MXNetError("embedding(sparse_grad=True): the row-sparse "
                         "gradient is ROADMAP A.7; use the dense gradient")
    return F.embedding(data.to(torch.long), weight)


def rope_positions(cos_table, sin_table, start_pos, length):
    """Gather per-row RoPE rows for positions ``start_pos[b] + [0..length)``
    from (S, D/2) tables; returns a ``(cos, sin)`` pair shaped
    (B, 1, length, D/2) — broadcastable over the head axis."""
    pos = (start_pos.to(device=cos_table.device, dtype=torch.long)[:, None]
           + torch.arange(length, device=cos_table.device))       # (B, T)
    return cos_table[pos][:, None], sin_table[pos][:, None]


def _ring_rows(cache, start_pos, t_len):
    """Ring index and in-ring mask of the rows ``start_pos[b] + [0..T)``,
    both (B, T). Rows past the ring's end are dropped, as in the JAX
    package: they are sent to ``pos - S``, which lies below ``start_pos``
    whenever ``T <= S`` and so never collides with a kept row, and write
    back the value already there. No branch on the mask, so no host
    synchronisation on the decode path."""
    s_len = cache.shape[2]
    if t_len > s_len:
        raise MXNetError(f"kv cache write of {t_len} rows into a ring of "
                         f"{s_len}")
    pos = (start_pos.to(device=cache.device, dtype=torch.long)[:, None]
           + torch.arange(t_len, device=cache.device))            # (B, T)
    return pos % s_len, pos < s_len


def kv_cache_write(cache, new, start_pos):
    """Write ``new`` (B, H, T, D) into the ring ``cache`` (B, H, S, D) at
    per-row positions ``start_pos[b] + [0..T)``; returns ``cache``.

    The write is **in place** (``scatter_``), where the JAX package
    rebuilds the whole ring functionally: at Llama-3-8B widths a rebuild
    would copy every layer's ring on every decode step. Written elements
    are copied, not merged, so the result equals the JAX op's bit for bit.
    """
    b, h, t_len, d = new.shape
    idx, keep = _ring_rows(cache, start_pos, t_len)
    idx4 = idx[:, None, :, None].expand(b, h, t_len, d)
    new = torch.where(keep[:, None, :, None], new.to(cache.dtype),
                      torch.gather(cache, 2, idx4))
    return cache.scatter_(2, idx4, new)


def kv_cache_write_q(cache_q, cache_scale, new, start_pos):
    """Quantize-on-write into an int8 KV ring: ``new`` (B, H, T, D) f32 is
    symmetric-quantized per token per head (scale = max|row| / 127 over D,
    rounded half to even, as ``jnp.round`` does) and written into
    ``cache_q`` (B, H, S, D) int8, with its scale row into ``cache_scale``
    (B, H, S) f32, at positions ``start_pos[b] + [0..T)``, in place like
    :func:`kv_cache_write`. Returns ``(cache_q, cache_scale)``."""
    b, h, t_len, d = new.shape
    scale = int8_scale(torch.amax(torch.abs(new), dim=-1))        # (B, H, T)
    nq = torch.clamp(torch.round(new / scale[..., None]),
                     -127, 127).to(torch.int8)
    idx, keep = _ring_rows(cache_q, start_pos, t_len)
    idx3 = idx[:, None, :].expand(b, h, t_len)
    idx4 = idx3[..., None].expand(b, h, t_len, d)
    nq = torch.where(keep[:, None, :, None], nq,
                     torch.gather(cache_q, 2, idx4))
    scale = torch.where(keep[:, None, :], scale,
                        torch.gather(cache_scale, 2, idx3))
    cache_q.scatter_(2, idx4, nq)
    cache_scale.scatter_(2, idx3, scale)
    return cache_q, cache_scale


def _int8_dot(data):
    """True where ``quantized_dense`` takes the int8 x int8 branch: a
    tensor on the card, whose tensor cores run int8 natively, as the JAX
    package takes it on a backend with int8 matrix units."""
    return data.is_cuda


def quantized_dense(data, qweight, scale, bias=None):
    """int8 fully-connected: ``data`` (..., U) f32 against a pre-quantized
    ``qweight`` (O, U) int8 with per-output-channel ``scale`` (O,) f32 and
    an optional ``bias`` (O,) f32. The branch follows where the tensors
    are, as the JAX package's follows its backend:

    * on the card, the JAX package's accelerator branch: each row of
      ``data`` quantized symmetrically (max|x| / 127), the product int8 x
      int8 -> int32 on the tensor cores, rescaled to f32 — the hand-written
      kernels of ``ops/hopper/int8_dense`` (``int8_dense``);
    * on the CPU, its weight-only branch: dequantize the weight, f32 gemm,
      scale the (..., O) output (U times cheaper than scaling the weight).

    Serving fast path only: ~1e-2 of the f32 gemm's largest output on the
    card, never bitwise against it."""
    if _int8_dot(data):
        return _i8.int8_dense(data.contiguous(), qweight, scale, bias)
    out = F.linear(data, qweight.to(torch.float32)) * scale
    return out + bias if bias is not None else out


def cached_attention(query, key, value, start_pos, scale=None,
                     path="pallas", k_scale=None, v_scale=None):
    """Causal attention of ``query`` (B, H, T, D) — absolute positions
    ``start_pos[b] + t`` — over *unexpanded* GQA rings (B, KV, S, D); an
    expanded ring (KV = H) is the same call. Positions past
    ``start_pos[b] + t`` are masked.

    ``path`` selects the formulation, as in the JAX op:

    * ``"baseline"``: the strict rung's shape-stable mul+reduce
      (``p = e / sum(e)``, f32 rings; the bitwise prefill/decode contract):
      ``ops/hopper/stable_ops`` (S2), head h reading KV head
      ``h // (H // KV)`` where the JAX cache path repeats the heads first;
    * any other value: the fast rungs' decode-attention kernel module
      (``ops/hopper/decode_attention``), optionally over int8 rings with
      (B, KV, S) ``k_scale``/``v_scale``; tolerance parity, not bitwise.

    The port's default stays ``"pallas"`` (the JAX op's is
    ``"baseline"``): every caller in the port names its path.
    """
    if path == "baseline":
        if k_scale is not None or v_scale is not None:
            raise MXNetError("cached_attention(path='baseline') takes f32 "
                             "rings, not int8 ones with scales")
        return _st.stable_attention(query, key, value, start_pos,
                                    scale=scale)
    return _da.decode_attention(query, key, value, start_pos, scale=scale,
                                k_scale=k_scale, v_scale=v_scale)


def stable_dense(data, weight, bias=None):
    """Shape-stable fully-connected: ``data`` (..., U) x ``weight`` (O, U)
    (+ ``bias`` (O,)) -> (..., O), every output one fixed-order sum over U
    whatever the leading shape (``mxnet_tpu.ops.nn.stable_dense``). On the
    card cuBLAS picks its kernel and split-K by the number of rows, so a
    ``F.linear`` row differs between T = 1 and T = bucket; this is
    ``ops/hopper/stable_ops``' S1 on CUDA tensors and its plain mul+reduce
    (chunked over O) on the CPU. Serving's strict rung only: training and
    the fast rungs keep ``dense``'s library product."""
    return _st.stable_dense(data, weight, bias)


def fusion_fence(data):
    """Identity. In the JAX package an XLA ``optimization_barrier`` that
    keeps the serving decode path from fusing reductions across decoder
    layers differently in the T = 1 and T = bucket executables. Eager
    PyTorch, and a CUDA graph captured from it, run each op as its own
    kernel and fuse nothing across layers, so the port's fence has nothing
    to pin; the strict cache path still calls it between layers, where the
    JAX package does."""
    return data


def attention(query, key, value, mask=None, causal=False, scale=None,
              use_flash=True, valid_length=None):
    """Scaled dot-product attention over (B, H, T, D) tensors, through the
    flash-attention kernel module (``ops/hopper/flash_attention``): the
    CUDA kernels forward and backward for CUDA tensors, their plain
    versions on the CPU. ``valid_length`` (B,) key lengths are masked
    inside the kernels; a dense ``mask`` takes the plain attention."""
    return _fa.attention(query, key, value, mask=mask, causal=causal,
                         scale=scale, use_flash=use_flash,
                         valid_length=valid_length)


def gather_positions(data, indices):
    """Per-row gather along axis 1: ``data`` (B, T, ...) at ``indices``
    (B,) -> (B, ...)."""
    rows = torch.arange(data.shape[0], device=data.device)
    return data[rows, indices.to(device=data.device, dtype=torch.long)]


def _full_f32(device):
    """cuDNN with TF32 off, for an f32 convolution on ``device``; every
    other flag as it stands. Nothing changes outside the block."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _weight_grad(data, grad, wshape, stride, pad):
    """The weight gradient of a 2-D convolution as one f32 matrix product
    a sample, summed over the batch: ``grad`` (N, O, L) times the unfolded
    input (N, I * kh * kw, L) transposed. cuDNN's own f32 weight-gradient
    algorithm sums long reductions less exactly: at ResNet-50's 3 x 3 shape
    (batch 2) it lands 1.1e-5 of the largest value from float64, this
    product 1.6e-6 (``chip_smoke.py`` phase 11a on an H100). A 1 x 1
    convolution needs no unfold: its columns are the (strided) input
    itself."""
    o, i, kh, kw = wshape
    n = data.shape[0]
    if (kh, kw) == (1, 1) and pad == (0, 0):
        cols = data[:, :, ::stride[0], ::stride[1]].reshape(n, i, -1)
    else:
        cols = F.unfold(data, (kh, kw), padding=pad, stride=stride)
    g = grad.reshape(n, o, -1)
    return torch.matmul(g, cols.transpose(1, 2)).sum(0).reshape(wshape)


class _ConvolutionF32(torch.autograd.Function):
    """An f32 2-D convolution whose forward and data gradient run with
    cuDNN's TF32 off, and whose weight gradient is an f32 matrix product
    (:func:`_weight_grad`; cuBLAS keeps f32 unless
    ``torch.backends.cuda.matmul.allow_tf32`` is set, which PyTorch leaves
    off). Autograd runs a backward after the forward's call has returned,
    under PyTorch's default ``cudnn.allow_tf32=True``, so the backward
    enters the same block itself."""

    @staticmethod
    def forward(ctx, data, weight, bias, stride, pad):
        ctx.save_for_backward(data, weight)
        ctx.stride, ctx.pad = stride, pad
        ctx.has_bias = bias is not None
        with _full_f32(data.device):
            return F.conv2d(data, weight, bias, stride, pad)

    @staticmethod
    def backward(ctx, grad):
        data, weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        with _full_f32(grad.device):
            gd, _, gb = torch.ops.aten.convolution_backward(
                grad, data, weight,
                [weight.shape[0]] if ctx.has_bias else None,
                ctx.stride, ctx.pad, [1, 1], False, [0, 0], 1,
                [need[0], False, ctx.has_bias and need[2]])
        gw = (_weight_grad(data, grad, weight.shape, ctx.stride, ctx.pad)
              if need[1] else None)
        return gd, gw, gb, None, None


def convolution(data, weight, bias=None, stride=1, pad=0):
    """2-D convolution, NCHW data and (O, I, kh, kw) weight, as
    ``mxnet_tpu.ops.nn.convolution`` lays it out. A float32 convolution
    keeps f32 in its forward and both gradients
    (:class:`_ConvolutionF32`): PyTorch's default
    (``torch.backends.cudnn.allow_tf32``) would keep about three decimal
    digits. No flag changes outside the call."""
    if data.dtype == torch.float32 and weight.dtype == torch.float32:
        st = (stride, stride) if isinstance(stride, int) else tuple(stride)
        pd = (pad, pad) if isinstance(pad, int) else tuple(pad)
        return _ConvolutionF32.apply(data, weight, bias, st, pd)
    return F.conv2d(data, weight, bias, stride, pad)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1, training=False):
    """Batch normalization over every axis but ``axis``, with the JAX
    package's arithmetic (``mxnet_tpu.ops.nn.batch_norm``). The JAX op
    reads ``autograd.is_training()``; here the caller passes ``training``
    (a module passes its ``training`` flag). ``fix_gamma`` (or a ``gamma``
    of None) takes gamma as 1. ``momentum`` is the layer's: the op does
    not touch the running statistics.

    Training (``training`` and not ``use_global_stats``) normalizes with
    the batch statistics:

    * float32 (and float64): the exact two-pass mean and population
      variance. ``F.batch_norm`` (cuDNN on the card) normalizes; the
      statistics for the caller come from ``torch.var_mean``;
    * 16-bit: one-pass float32 statistics, ``E[x^2] - E[x]^2`` clamped at
      0; ``gamma * rsqrt(var + eps)`` and the mean rounded to x's dtype,
      and the normalization in x's dtype, as the JAX op does under AMP.

    Otherwise the running statistics normalize: ``F.batch_norm`` when x,
    gamma, beta and the statistics are all float32 or float64, else the
    JAX formula ``(x - mean) * gamma / sqrt(var + eps) + beta`` in the
    dtypes given (they promote as ``jnp`` does).

    With ``output_mean_var`` returns ``(out, mean, var)``: in training
    the batch mean and population variance (float32 for a 16-bit x),
    detached, for the layer's running update; else the running ones."""
    del momentum  # the layer's running update reads it
    axis = axis % x.dim()
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    gamma = None if fix_gamma else gamma
    if training and not use_global_stats:
        axes = tuple(i for i in range(x.dim()) if i != axis)
        if x.element_size() <= 2:
            x32 = x.to(torch.float32)
            mean = x32.mean(dim=axes)
            var = torch.clamp(torch.square(x32).mean(dim=axes)
                              - torch.square(mean), min=0.0)
            inv_c = 1.0 / torch.sqrt(var + eps)
            inv = inv_c if gamma is None else gamma.to(torch.float32) * inv_c
            out = ((x - mean.to(x.dtype).reshape(shape))
                   * inv.to(x.dtype).reshape(shape) + beta.reshape(shape))
            mean, var = mean.detach(), var.detach()
        else:
            if axis == 1:
                out = F.batch_norm(x, None, None, gamma, beta, training=True,
                                   eps=eps)
            else:
                mean = x.mean(dim=axes, keepdim=True)
                var = x.var(dim=axes, keepdim=True, correction=0)
                inv = 1.0 / torch.sqrt(var + eps)
                if gamma is not None:
                    inv = gamma.reshape(shape) * inv
                out = (x - mean) * inv + beta.reshape(shape)
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=axes, correction=0)
        return (out, mean, var) if output_mean_var else out
    same = {t.dtype for t in (x, gamma, beta, running_mean, running_var)
            if t is not None}
    if axis == 1 and (same <= {torch.float32} or same <= {torch.float64}):
        out = F.batch_norm(x, running_mean, running_var, gamma, beta,
                           training=False, eps=eps)
    else:
        den = torch.sqrt(running_var.reshape(shape) + eps)
        inv = 1.0 / den if gamma is None else gamma.reshape(shape) / den
        out = (x - running_mean.reshape(shape)) * inv + beta.reshape(shape)
    return (out, running_mean, running_var) if output_mean_var else out


# ---------------------------------------------------------------------------
# On-device sampling for the multi-step decode super-step
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # 2**32 / golden ratio: spreads consecutive counters


def _mul32(x, c):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, in two 16-bit halves so that every product stays below
    2**49: int64 never overflows, on the CPU or the GPU."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A bijective 32-bit integer finalizer (the "lowbias32" xorshift-
    multiply chain) on int64 tensors holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniform(key, seeds, positions, vocab):
    """(B, vocab) float64 uniforms in (0, 1), a pure function of the
    (2,) base ``key`` (two 32-bit words in int32 or int64), each row's
    stream ``seeds[b]``, its ``positions[b]`` and the vocabulary index:
    integer hashing only, so the CPU and the GPU give the same bits and no
    ``torch.Generator`` state is read or advanced."""
    k = key.to(torch.int64) & _M32
    h = _mix32(k[0] ^ (seeds.to(torch.int64) & _M32))
    h = _mix32(h ^ k[1])
    h = _mix32((h ^ (positions.to(torch.int64) & _M32)) + _GOLDEN & _M32)
    v = _mul32(torch.arange(vocab, dtype=torch.int64, device=h.device),
               _GOLDEN)
    bits = _mix32((_mix32(h[:, None] ^ v[None, :]) + _GOLDEN) & _M32)
    return ((bits >> 8).to(torch.float64) + 0.5) * (1.0 / (1 << 24))


def sample_step(logits, temperature, top_k, seeds, positions, key_bits):
    """Next-token choice inside the multi-step decode super-step
    (counterpart of ``mxnet_tpu.ops.nn.sample_step``).

    ``logits`` (B, V) f32; per-row ``temperature`` (B,) f32 (<= 0 means
    greedy argmax, ties to the lowest id), ``top_k`` (B,) int32 (0 or >= V
    means no truncation; otherwise values >= the k-th largest survive, ties
    included), ``seeds`` (B,) int32 (one stream per serving slot),
    ``positions`` (B,) int32 (the absolute position whose successor is
    drawn) and ``key_bits`` (2,) the base key.

    Keying is counter-based, as in the JAX package: row ``b``'s draw is a
    pure function of (key, seed, position, vocabulary index)
    (:func:`counter_uniform`), so N iterations per super-step and one give
    identical streams. The bits are not JAX's threefry bits: the draw is
    Gumbel-max over the top-k-masked ``logits / temperature``, the same
    distribution as ``jax.random.categorical``. The Gumbel noise is
    computed in float64 and rounded to float32, so the CPU and the GPU
    agree on it. Every branch is a tensor expression (no host read), so
    the op can be captured in a CUDA graph; the JAX op's ``lax.cond`` that
    spares an all-greedy batch the sampled branch is the caller's choice
    here (``serve.generate`` captures a greedy graph without it).

    Returns (B,) int32 token ids.
    """
    b, v = logits.shape
    lg = logits.to(torch.float32)
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    temp = temperature.to(device=lg.device, dtype=torch.float32)
    scaled = lg / torch.clamp(temp, min=1e-6)[:, None]
    k = top_k.to(device=lg.device, dtype=torch.int64)
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(srt, 1, (torch.clamp(k, 1, v) - 1)[:, None])
    keep = (scaled >= kth) | ~((k > 0) & (k < v))[:, None]
    u = counter_uniform(key_bits.to(lg.device), seeds.to(lg.device),
                        positions.to(lg.device), v)
    gumbel = (-torch.log(-torch.log(u))).to(torch.float32)
    sampled = torch.argmax(scaled.masked_fill(~keep, float("-inf"))
                           + gumbel, dim=-1).to(torch.int32)
    return torch.where(temp > 0.0, sampled, greedy)


# ---------------------------------------------------------------------------
# Paged KV-cache ops (serve.kv_blocks)
#
# Each slot's KV rows live in one page pool per layer — (P, KV, page, D)
# for the rings, (P, KV, page) for the int8 scale pools — and a (B, N)
# page table maps slot b's logical page i to a pool page id; id 0 is the
# reserved null page. Both ops are pure data movement (index_select and
# an index_put copy, never an arithmetic merge), so gather -> the
# unchanged cache path -> scatter reads and writes exactly the bytes the
# ring path would.
# ---------------------------------------------------------------------------


def paged_kv_gather(pool, page_table):
    """Materialize per-slot contiguous KV rings from a paged pool.

    ``pool`` is (P, KV, page, D) — or (P, KV, page) for a scale pool — and
    ``page_table`` (B, N) int maps slot ``b``'s logical page ``i`` to a pool
    page id (0 = the null page, kept zeroed by :func:`paged_kv_scatter`).
    Returns a new contiguous (B, KV, N*page, D) ring (or (B, KV, N*page)):
    an exact copy. Positions the slot does not own read null-page zeros;
    the attention position mask never admits them before they are
    written."""
    b, n = page_table.shape
    g = torch.index_select(pool, 0, page_table.reshape(-1)
                           .to(device=pool.device, dtype=torch.long))
    g = g.reshape((b, n) + tuple(pool.shape[1:]))   # (B, N, KV, pg[, D])
    g = g.transpose(1, 2)                           # (B, KV, N, pg[, D])
    return g.reshape((b, pool.shape[1], n * pool.shape[2])
                     + tuple(pool.shape[3:]))


def paged_kv_scatter(pool, page_table, ring, start_pos, length):
    """Write the ``length`` ring rows at positions ``start_pos[b] +
    [0..length)`` of ``ring`` (B, KV, S, D) — or a (B, KV, S) scale ring —
    into ``pool`` through ``page_table`` (B, N); returns ``pool``.

    The write is **in place** (an ``index_put_`` copy), where the JAX
    package returns a new pool: a rebuilt pool would copy every layer's
    pages per step, and a captured CUDA graph needs the pool where it was.
    Written elements are copied, not merged, so the result equals the JAX
    op's bit for bit. Positions are clipped to the ring and page indices
    to the table, as in the JAX op; slots whose table rows are null (dead
    lanes) write page 0, which is re-zeroed at the end, so the null page
    always reads as zeros."""
    page = pool.shape[2]
    n_pages = page_table.shape[1]
    s_len = ring.shape[2]
    dev = pool.device
    pos = (start_pos.to(device=dev, dtype=torch.long)[:, None]
           + torch.arange(length, device=dev))                    # (B, L)
    pos = torch.clamp(pos, 0, s_len - 1)
    pid = torch.gather(page_table.to(device=dev, dtype=torch.long), 1,
                       torch.clamp(pos // page, 0, n_pages - 1))  # (B, L)
    off = pos % page
    b, kv = ring.shape[:2]
    if ring.dim() == 4:
        d = ring.shape[3]
        rows = torch.gather(ring, 2,
                            pos[:, None, :, None].expand(b, kv, length, d))
        vals = rows.permute(0, 2, 1, 3)                   # (B, L, KV, D)
    else:
        rows = torch.gather(ring, 2, pos[:, None, :].expand(b, kv, length))
        vals = rows.permute(0, 2, 1)                      # (B, L, KV)
    pool[pid, :, off] = vals.to(pool.dtype)
    pool[0].zero_()
    return pool
