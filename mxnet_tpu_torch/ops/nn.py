"""Neural-network ops of the ported slices, as functions on tensors.

Each mirrors its namesake in ``mxnet_tpu/ops/nn.py`` (same arguments, same
layouts, same arithmetic), so the tests can feed one set of numpy inputs
through both packages. The JAX package's ops are pure; the KV-cache writes
here update the ring in place (see :func:`kv_cache_write`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .hopper import decode_attention as _da
from .hopper import flash_attention as _fa


def activation(data, act_type="relu"):
    """Elementwise activation: ``relu`` (ResNet) and ``silu`` (Llama's
    SwiGLU) are ported."""
    if act_type == "relu":
        return F.relu(data)
    if act_type == "silu":
        return F.silu(data)
    raise MXNetError(f"activation {act_type!r} is not ported yet (relu, "
                     "silu)")


def rms_norm(data, gamma, axis=-1, eps=1e-6):
    """RMSNorm: ``x / sqrt(mean(x^2) + eps) * gamma`` along ``axis``."""
    ms = torch.mean(torch.square(data.to(torch.float32)), dim=axis,
                    keepdim=True)
    out = data * (1.0 / torch.sqrt(ms + eps)).to(data.dtype)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return out * gamma.reshape(shape)


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


def int8_scale(amax):
    """Symmetric int8 scale ``max(amax / 127, 1e-8)`` of rows whose largest
    magnitude is ``amax``. The divisor is a tensor on ``amax``'s device:
    PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, one ulp away from the true quotient that ``jnp`` and the
    CPU give."""
    return torch.clamp(amax / amax.new_tensor(127.0), min=1e-8)


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


def quantized_dense(data, qweight, scale, bias=None):
    """int8 fully-connected, weight-only: ``data`` (..., U) f32 against a
    pre-quantized ``qweight`` (O, U) int8 with per-output-channel ``scale``
    (O,) f32 — the JAX package's non-TPU formulation (dequantize the weight,
    f32 gemm, scale the (..., O) output, which is U times cheaper than
    scaling the weight). The int8 x int8 gemm of its TPU branch needs a
    kernel of its own and is not ported."""
    out = F.linear(data, qweight.to(torch.float32)) * scale
    return out + bias if bias is not None else out


def cached_attention(query, key, value, start_pos, scale=None,
                     path="pallas", k_scale=None, v_scale=None):
    """Causal attention of ``query`` (B, H, T, D) — absolute positions
    ``start_pos[b] + t`` — over *unexpanded* GQA rings (B, KV, S, D),
    optionally int8 with (B, KV, S) ``k_scale``/``v_scale``, through the
    decode-attention kernel module (``ops/hopper/decode_attention``).

    Only the fast path of the JAX op is ported: its ``"baseline"``
    mul+reduce formulation comes with the baseline rung in a later slice.
    """
    if path == "baseline":
        raise NotImplementedError(
            "cached_attention(path='baseline') is the strict rung's "
            "mul+reduce formulation, ported with the baseline rung in a "
            "later slice of the serving port")
    return _da.decode_attention(query, key, value, start_pos, scale=scale,
                                k_scale=k_scale, v_scale=v_scale)


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


def convolution(data, weight, bias=None, stride=1, pad=0):
    """2-D convolution, NCHW data and (O, I, kh, kw) weight, as
    ``mxnet_tpu.ops.nn.convolution`` lays it out. A float32 convolution on
    a CUDA tensor runs with cuDNN's TF32 off inside this call: PyTorch's
    default (``torch.backends.cudnn.allow_tf32``) would keep about three
    decimal digits. No flag changes outside the call."""
    if data.is_cuda and data.dtype == torch.float32:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            return F.conv2d(data, weight, bias, stride, pad)
    return F.conv2d(data, weight, bias, stride, pad)
