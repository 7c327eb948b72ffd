"""Flash attention, forward and backward, on Hopper.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``. The cache-free
Llama forward (training) runs every layer's attention through
:func:`attention`, which routes to :class:`_FlashCore`, the counterpart of
the JAX package's ``_flash_core`` custom VJP. Its forward launches the
hand-written CUDA kernel ``flash_fwd`` and its backward the kernels
``flash_bwd_dq`` and ``flash_bwd_dkv`` (all three in
``mxnet_tpu_torch/csrc/flash_attention.cu``, the ports of the TPU kernels
``_flash_fwd``, ``_flash_bwd_dq`` and ``_flash_bwd_dkv``). All three run
every product on the tensor cores in 3xTF32 (each f32 operand split into
two TF32 parts, three products summed in f32), which keeps f32 accuracy;
the (bf16, bf16) pair's three kernels (``flash_fwd_bf16_kernel``,
``flash_bwd_dq_bf16_kernel``, ``flash_bwd_dkv_bf16_kernel``) run bf16
products instead: one pass for two bf16 operands, three for the f32 P and
dS, each split into three bf16 pieces (the same accuracy from bf16 tiles).

Dtypes, as the TPU kernels take them: q and k (and the cotangent g) share
one dtype and v has its own, each float32, bfloat16 or float16. The kernels
compute in f32 (every operand widened to f32 as it enters shared memory,
except in the (bf16, bf16) kernels, whose tiles stay bf16 and whose scores,
P and dS are f32) and write ``out`` and ``dq`` in q's dtype, ``dk`` in k's
and ``dv`` in v's; ``lse`` and ``delta`` are f32.
:func:`kernel_attributes` reads each kernel's registers, spills and blocks
an SM. A library of the kernels is built for each (q/k, v) pair of
:data:`DTYPE_PAIRS`: (f32, f32); (f32, bf16) and (f32, f16), which a Llama
layer's attention gets under ``ShardedTrainer(dtype=...)``, whose f32 RoPE
tables promote q and k but not v; (bf16, bf16) and (f16, f16). Any other
pair, or k of another dtype than q, raises :class:`MXNetError` naming it;
nothing is cast in front of a kernel. The plain versions take the same
dtypes: they compute in f32 and cast each result to its primal's dtype.

Each kernel has a plain PyTorch version with the kernel's own signature
(:func:`flash_fwd_torch`, :func:`flash_bwd_dq_torch`,
:func:`flash_bwd_dkv_torch`), and :func:`attention_torch` is the plain
version of the whole op, the counterpart of ``_reference_attention``. Like
the reference, it gives zeros on a row whose every key is masked, where
``F.scaled_dot_product_attention`` gives NaN.

Routing depends only on where the tensors live, on their shapes and on the
arguments, never on values:

* a dense ``mask``, ``use_flash=False`` or ``force_path("torch")``:
  :func:`attention_torch` under autograd, as the JAX package routes a
  dense mask to its XLA path;
* otherwise CUDA tensors go to :class:`_FlashCore` on the three kernels, or
  raise (head dim above 256, dtypes, devices): nothing falls back;
* CPU tensors go to :class:`_FlashCore` on the kernels' plain versions
  (or to :func:`attention_torch` when D > 256), so the CPU tests drive
  the autograd function end to end;
* ``force_path("versions")`` sends tensors of any device that way: the
  kernels' plain versions under :class:`_FlashCore`, which score in f32 as
  the kernels do, where :func:`attention_torch` rounds narrow scores to
  their dtype as the JAX package's XLA path does.

The JAX package's TPU facts are not copied: no padding of T to 128-row
blocks or of D to 128 lanes (the kernels mask the ragged edge), no
1024/512 maximum blocks, and no ``T_q * T_k > 1024**2`` crossover (measured
on a v5e); ``chip_smoke.py`` records the kernel against the library call at
several T instead.

``last_path()`` says which version the last call took ("cuda" | "torch"),
and ``launch_count()`` counts the launches of each kernel
(``{"fwd", "bwd_dq", "bwd_dkv"}``), bumped only after a launch returns
``cudaSuccess``; ``launch_count(pair)`` counts those of one dtype pair.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...base import MXNetError

_NEG_INF = -1e30  # finite "minus infinity": keeps fully-masked rows NaN-free
_MAX_D = 256
KERNELS = ("fwd", "bwd_dq", "bwd_dkv")

_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16
# dtype codes of the CUDA source's MXTT_FLASH_QK / MXTT_FLASH_V
_CODES = {_F32: 0, _BF16: 1, _F16: 2}
_SHORT = {_F32: "f32", _BF16: "bf16", _F16: "f16"}
# (q/k dtype, v dtype) pairs with an instantiation of the kernels
DTYPE_PAIRS = ((_F32, _F32), (_F32, _BF16), (_F32, _F16), (_BF16, _BF16),
               (_F16, _F16))

_LAST_PATH = None  # "cuda" | "torch": the version the last call took
_FORCE_PATH = None
_LAUNCHES = {(name, pair): 0 for name in KERNELS for pair in DTYPE_PAIRS}
_LIBS = {}  # dtype pair -> ctypes.CDLL


def force_path(path) -> None:
    """Override routing: ``None`` (by device and shape), ``"torch"``
    (:func:`attention_torch`, on any device), ``"versions"`` (the kernels'
    plain versions under the autograd function, on any device) or
    ``"cuda"`` (the kernels; raises for CPU tensors)."""
    global _FORCE_PATH
    if path not in (None, "torch", "versions", "cuda"):
        raise ValueError(f"force_path: {path!r} not in "
                         "(None,'torch','versions','cuda')")
    _FORCE_PATH = path


def last_path():
    return _LAST_PATH


def pair_label(pair) -> str:
    """``"f32"``, ``"bf16"``, ``"f16"`` for a pair of one dtype, else
    ``"<q/k>_<v>"`` (``"f32_bf16"``)."""
    qk, v = pair
    return _SHORT[qk] if qk == v else f"{_SHORT[qk]}_{_SHORT[v]}"


def launch_count(pair=None) -> dict:
    """Kernel launches since import (or the last reset), by kernel: of all
    dtype pairs, or of ``pair`` ((q/k dtype, v dtype)) alone."""
    return {name: sum(n for (k, p), n in _LAUNCHES.items()
                      if k == name and (pair is None or p == tuple(pair)))
            for name in KERNELS}


def reset_launch_count() -> None:
    for key in _LAUNCHES:
        _LAUNCHES[key] = 0


def _scale_of(scale, d):
    return scale if scale is not None else 1.0 / math.sqrt(d)


# -- plain versions -----------------------------------------------------------


def attention_torch(q, k, v, mask=None, causal=False, scale=None,
                    valid_length=None):
    """Plain PyTorch attention over (B, H, T, D), the counterpart of
    ``_reference_attention``: the (Tq, Tk) scores are materialized; rows
    whose every key is masked give zeros (and zero gradients). Mixed dtypes
    promote as ``jnp`` promotes them: the scores in q and k's common
    dtype, the weights in q's, the output in q and v's common dtype."""
    s = _scale_of(scale, q.shape[-1])
    qk = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(qk), k.to(qk)) * s
    tq, tk = scores.shape[-2], scores.shape[-1]
    neg = torch.tensor(_NEG_INF, dtype=scores.dtype, device=scores.device)
    if causal:
        cm = torch.ones(tq, tk, dtype=torch.bool,
                        device=scores.device).tril(diagonal=tk - tq)
        scores = torch.where(cm, scores, neg)
    if valid_length is not None:
        kpos = torch.arange(tk, device=scores.device).reshape(1, 1, 1, tk)
        vl = torch.as_tensor(valid_length, device=scores.device).to(
            torch.int32).reshape(-1, 1, 1, 1)
        scores = torch.where(kpos < vl, scores, neg)
    if mask is not None:
        scores = torch.where(mask.to(torch.bool), scores, neg)
    w = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    alive = torch.amax(scores, dim=-1, keepdim=True) > _NEG_INF / 2
    w = torch.where(alive, w, torch.zeros((), dtype=w.dtype, device=w.device))
    out = torch.promote_types(w.dtype, v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(out), v.to(out))


def _keep_mask(kvalid, bh, tq, tk, causal, causal_off, device):
    """(BH, Tq, Tk) bool of the kept (query, key) pairs."""
    b = kvalid.shape[0]
    kpos = torch.arange(tk, device=device)
    keep = kpos[None, None, :] < kvalid.to(device).repeat_interleave(
        bh // b)[:, None, None].to(torch.long)
    if causal:
        qpos = torch.arange(tq, device=device)
        keep = keep & (kpos[None, :] <= qpos[:, None] + causal_off)[None]
    return keep


def _probs(q, k, lse, kvalid, causal, causal_off, scale):
    """P = exp(S - lse) of the kept pairs (0 elsewhere and on dead rows),
    with S = (q * scale) . k^T, as the backward kernels recompute it."""
    bh, tq, _ = q.shape
    sc = torch.matmul(q * scale, k.transpose(1, 2))
    keep = _keep_mask(kvalid, bh, tq, k.shape[1], causal, causal_off,
                      q.device)
    keep = keep & (lse > _NEG_INF / 2)[:, :, None]
    zero = torch.zeros((), dtype=sc.dtype, device=sc.device)
    return torch.where(keep, torch.exp(sc - lse[:, :, None]), zero)


def _f32(*xs):
    return [x.to(torch.float32) for x in xs]


def flash_fwd_torch(q, k, v, kvalid, causal, causal_off, scale):
    """Plain version of the ``flash_fwd`` kernel: q (BH, Tq, D), k/v
    (BH, Tk, D), kvalid (B,) int32 -> (out (BH, Tq, D) in q's dtype,
    lse (BH, Tq) f32), computed in f32. A row with no kept key gives
    out = 0 and lse = -1e30."""
    dtype = q.dtype
    q, k, v = _f32(q, k, v)
    bh, tq, _ = q.shape
    sc = torch.matmul(q * scale, k.transpose(1, 2))
    keep = _keep_mask(kvalid, bh, tq, k.shape[1], causal, causal_off,
                      q.device)
    neg = torch.tensor(_NEG_INF, dtype=sc.dtype, device=sc.device)
    sc = torch.where(keep, sc, neg)
    m = torch.amax(sc, dim=-1, keepdim=True)
    alive = m > _NEG_INF / 2
    p = torch.where(alive, torch.exp(sc - m), torch.zeros_like(neg))
    l = p.sum(dim=-1, keepdim=True)
    lsafe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p, v) / lsafe
    lse = torch.where(l == 0, neg, m + torch.log(lsafe))
    return out.to(dtype), lse[..., 0]


def flash_bwd_dq_torch(q, k, v, g, lse, delta, kvalid, causal, causal_off,
                       scale):
    """Plain version of the ``flash_bwd_dq`` kernel:
    dq = scale * (P * (g . v^T - delta)) . k, in f32, returned in q's
    dtype."""
    dtype = q.dtype
    q, k, v, g = _f32(q, k, v, g)
    p = _probs(q, k, lse, kvalid, causal, causal_off, scale)
    ds = p * (torch.matmul(g, v.transpose(1, 2)) - delta[:, :, None])
    return (torch.matmul(ds, k) * scale).to(dtype)


def flash_bwd_dkv_torch(q, k, v, g, lse, delta, kvalid, causal, causal_off,
                        scale):
    """Plain version of the ``flash_bwd_dkv`` kernel:
    dv = P^T . g, dk = (P * (g . v^T - delta))^T . (q * scale), in f32,
    returned in k's and v's dtypes."""
    k_dtype, v_dtype = k.dtype, v.dtype
    q, k, v, g = _f32(q, k, v, g)
    p = _probs(q, k, lse, kvalid, causal, causal_off, scale)
    ds = p * (torch.matmul(g, v.transpose(1, 2)) - delta[:, :, None])
    dv = torch.matmul(p.transpose(1, 2), g)
    dk = torch.matmul(ds.transpose(1, 2), q * scale)
    return dk.to(k_dtype), dv.to(v_dtype)


# -- the CUDA kernels -----------------------------------------------------------


def build_spec(pair):
    """The ``_build`` variant of ``pair``'s library: ``("flash_attention",
    defines)``; the f32 pair builds with no defines."""
    qk, v = pair
    if (qk, v) == (_F32, _F32):
        return ("flash_attention", ())
    return ("flash_attention", (f"MXTT_FLASH_QK={_CODES[qk]}",
                                f"MXTT_FLASH_V={_CODES[v]}"))


def _lib(pair=(_F32, _F32)):
    lib = _LIBS.get(pair)
    if lib is None:
        from ._build import load

        lib = load(*build_spec(pair))
        lib.mxtt_flash_dtypes.restype = ctypes.c_int
        want = 16 * _CODES[pair[0]] + _CODES[pair[1]]
        got = lib.mxtt_flash_dtypes()
        if got != want:
            # a library of another pair would read the tensors as the wrong
            # element type: refuse it
            raise MXNetError(f"flash kernels for {pair_label(pair)}: the "
                             f"loaded library was built for code {got}, "
                             f"want {want}")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 7 + [ctypes.c_float, ptr]
        lib.mxtt_flash_fwd.argtypes = [ptr] * 6 + tail
        lib.mxtt_flash_bwd_dq.argtypes = [ptr] * 8 + tail
        lib.mxtt_flash_bwd_dkv.argtypes = [ptr] * 9 + tail
        for fn in (lib.mxtt_flash_fwd, lib.mxtt_flash_bwd_dq,
                   lib.mxtt_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.mxtt_flash_smem_bytes.argtypes = [i32, i32]
        lib.mxtt_flash_smem_bytes.restype = ctypes.c_longlong
        lib.mxtt_flash_error_string.argtypes = [i32]
        lib.mxtt_flash_error_string.restype = ctypes.c_char_p
        lib.mxtt_flash_kernel_attributes.argtypes = [
            i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
        lib.mxtt_flash_kernel_attributes.restype = ctypes.c_int
        _LIBS[pair] = lib
    return lib


ATTRIBUTES = ("registers", "local_bytes", "blocks_per_sm", "threads",
              "smem_bytes")


def kernel_attributes(pair=(_F32, _F32), d=128, vec=True) -> dict:
    """``{kernel: {attribute: int}}`` of ``pair``'s kernels as they launch at
    head dim ``d`` (``vec``: the instantiation of 16-byte copies, else the
    narrow one): registers and local (spill) bytes a thread
    (``cudaFuncGetAttributes``), the most blocks an SM holds at the kernel's
    dynamic shared memory (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    threads a block and that shared memory in bytes. Builds the library;
    needs the card."""
    pair = tuple(pair)
    lib = _lib(pair)
    out = (ctypes.c_int * len(ATTRIBUTES))()
    res = {}
    for i, name in enumerate(KERNELS):
        err = lib.mxtt_flash_kernel_attributes(i, int(d), int(bool(vec)), out)
        if err != 0:
            raise MXNetError(
                f"flash {name} attributes ({pair_label(pair)}, D {d}): "
                f"{lib.mxtt_flash_error_string(err).decode()} (cudaError "
                f"{err})")
        res[name] = dict(zip(ATTRIBUTES, list(out)))
    return res


def build() -> None:
    """Build (one ``nvcc`` per dtype pair, all started together) and load
    the kernel libraries now; they are otherwise built at the first launch
    of each pair."""
    from ._build import build_many

    build_many([build_spec(p) for p in DTYPE_PAIRS])
    for p in DTYPE_PAIRS:
        _lib(p)


def _check_launch(name, q, k, v, kvalid, rest):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise MXNetError(f"flash {name}: q, k, v must be 3-D (BH, T, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, tq, d = q.shape
    tk = k.shape[1]
    if tuple(k.shape) != (bh, tk, d) or tuple(v.shape) != (bh, tk, d):
        raise MXNetError(f"flash {name}: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not (0 < d <= _MAX_D):
        raise MXNetError(f"flash {name} kernel: head_dim {d} not in "
                         f"1..{_MAX_D}")
    if bh == 0 or tq == 0 or tk == 0:
        raise MXNetError(f"flash {name} kernel: empty shape q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    b = kvalid.shape[0] if kvalid.dim() == 1 else -1
    if b <= 0 or bh % b or kvalid.dtype != torch.int32:
        raise MXNetError(f"flash {name}: kvalid must be int32 (B,) with B "
                         f"dividing {bh}, got {kvalid.dtype} "
                         f"{tuple(kvalid.shape)}")
    pair = (q.dtype, v.dtype)
    if k.dtype != q.dtype or pair not in DTYPE_PAIRS:
        pairs = ", ".join(f"({a}, {b})" for a, b in DTYPE_PAIRS)
        raise MXNetError(
            f"flash {name} kernel: no instantiation for q {q.dtype}, k "
            f"{k.dtype}, v {v.dtype}; the (q/k, v) pairs are {pairs}")
    want = {"kvalid": torch.int32, "g": q.dtype, "lse": torch.float32,
            "delta": torch.float32}
    for label, x, shape in [("q", q, None), ("k", k, None), ("v", v, None),
                            ("kvalid", kvalid, None)] + rest:
        if x.device != q.device:
            raise MXNetError(f"flash {name}: {label} on {x.device}, q on "
                             f"{q.device}")
        if not x.is_contiguous():
            raise MXNetError(f"flash {name}: {label} is not contiguous")
        if label in want and x.dtype != want[label]:
            raise MXNetError(f"flash {name} kernel: {label} must be "
                             f"{want[label]}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise MXNetError(f"flash {name}: {label} must be {shape}, got "
                             f"{tuple(x.shape)}")
    return pair


def _launch(name, pair, ptrs, q, k, kvalid, causal, causal_off, scale):
    bh, tq, d = q.shape
    tk = k.shape[1]
    h = bh // kvalid.shape[0]
    lib = _lib(pair)
    fn = getattr(lib, f"mxtt_flash_{name}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, bh, h, tq, tk, d, int(bool(causal)), int(causal_off),
                 float(scale), stream)
    if err != 0:
        kernel = KERNELS.index(name)
        raise MXNetError(
            f"flash {name} kernel launch failed: "
            f"{lib.mxtt_flash_error_string(err).decode()} (cudaError {err}; "
            f"{pair_label(pair)}, q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"shared memory {lib.mxtt_flash_smem_bytes(kernel, d)} B)")
    _LAUNCHES[(name, pair)] += 1


def _use_kernel(q):
    """True to launch the kernel for ``q`` (a CUDA tensor unless
    ``force_path("versions")``); raises for a CPU tensor under
    ``force_path("cuda")``."""
    global _LAST_PATH
    if _FORCE_PATH == "cuda" or (_FORCE_PATH is None and q.is_cuda):
        if not q.is_cuda:
            raise MXNetError("force_path('cuda'): the flash-attention "
                             f"kernels need CUDA tensors, got {q.device}")
        _LAST_PATH = "cuda"
        return True
    _LAST_PATH = "torch"
    return False


def flash_fwd(q, k, v, kvalid, causal, causal_off, scale):
    """The forward kernel (CUDA tensors) or its plain version (CPU):
    q (BH, Tq, D), k/v (BH, Tk, D), kvalid (B,) int32 -> (out, lse)."""
    if not _use_kernel(q):
        return flash_fwd_torch(q, k, v, kvalid, causal, causal_off, scale)
    pair = _check_launch("fwd", q, k, v, kvalid, [])
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("fwd", pair, [x.data_ptr() for x in (q, k, v, kvalid, out, lse)],
            q, k, kvalid, causal, causal_off, scale)
    return out, lse


def _bwd_rest(q, g, lse, delta):
    rows = tuple(q.shape[:2])
    return [("g", g, tuple(q.shape)), ("lse", lse, rows),
            ("delta", delta, rows)]


def flash_bwd_dq(q, k, v, g, lse, delta, kvalid, causal, causal_off, scale):
    """The dq kernel (CUDA tensors) or its plain version (CPU)."""
    if not _use_kernel(q):
        return flash_bwd_dq_torch(q, k, v, g, lse, delta, kvalid, causal,
                                  causal_off, scale)
    pair = _check_launch("bwd_dq", q, k, v, kvalid,
                         _bwd_rest(q, g, lse, delta))
    dq = torch.empty_like(q)
    _launch("bwd_dq", pair,
            [x.data_ptr() for x in (q, k, v, g, lse, delta, kvalid, dq)],
            q, k, kvalid, causal, causal_off, scale)
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, kvalid, causal, causal_off, scale):
    """The dk/dv kernel (CUDA tensors) or its plain version (CPU)."""
    if not _use_kernel(q):
        return flash_bwd_dkv_torch(q, k, v, g, lse, delta, kvalid, causal,
                                   causal_off, scale)
    pair = _check_launch("bwd_dkv", q, k, v, kvalid,
                         _bwd_rest(q, g, lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("bwd_dkv", pair,
            [x.data_ptr() for x in (q, k, v, g, lse, delta, kvalid, dk, dv)],
            q, k, kvalid, causal, causal_off, scale)
    return dk, dv


# -- autograd function and public entry ----------------------------------------


def kvalid_of(valid_length, b, tk, device):
    """(B,) int32 valid key counts, clamped to Tk (``_kvalid_array``)."""
    if valid_length is None:
        return torch.full((b,), tk, dtype=torch.int32, device=device)
    vl = torch.as_tensor(valid_length, device=device).to(torch.int32)
    return torch.clamp(vl, max=tk).reshape(b).contiguous()


class _FlashCore(torch.autograd.Function):
    """Counterpart of ``_flash_core``: the forward kernel saves
    ``(q, k, v, out, lse, kvalid)``; the backward casts dO to q's dtype,
    computes ``delta = rowsum(dO * O)`` in f32 with a torch op, then runs
    the dq and dk/dv kernels (``_flash_core_bwd``). Each kernel call goes to
    its plain version for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, valid_length, causal, scale):
        b, h, tq, d = q.shape
        tk = k.shape[2]
        q3 = q.reshape(b * h, tq, d).contiguous()
        k3 = k.reshape(b * h, tk, d).contiguous()
        v3 = v.reshape(b * h, tk, d).contiguous()
        kvalid = kvalid_of(valid_length, b, tk, q.device)
        # the causal diagonal from the unpadded lengths
        ctx.causal, ctx.causal_off = bool(causal), tk - tq
        ctx.scale = _scale_of(scale, d)
        out, lse = flash_fwd(q3, k3, v3, kvalid, ctx.causal, ctx.causal_off,
                             ctx.scale)
        ctx.save_for_backward(q3, k3, v3, out, lse, kvalid)
        ctx.shapes = (q.shape, k.shape)
        return out.view(q.shape)

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out, lse, kvalid = ctx.saved_tensors
        q_shape, k_shape = ctx.shapes
        g3 = g.reshape(q3.shape).to(q3.dtype).contiguous()
        # delta_i = rowsum(dO_i * O_i), a plain reduce outside the kernels
        delta = torch.sum(g3.to(torch.float32) * out.to(torch.float32),
                          dim=-1).contiguous()
        args = (kvalid, ctx.causal, ctx.causal_off, ctx.scale)
        dq = flash_bwd_dq(q3, k3, v3, g3, lse, delta, *args)
        dk, dv = flash_bwd_dkv(q3, k3, v3, g3, lse, delta, *args)
        return (dq.view(q_shape), dk.view(k_shape), dv.view(k_shape), None,
                None, None)


def attention(q, k, v, mask=None, causal=False, scale=None, use_flash=True,
              valid_length=None):
    """Scaled dot-product attention over (B, H, T, D) tensors.

    ``valid_length``: (B,) key lengths, masked inside the kernels without a
    (T, T) mask. ``mask``: a dense boolean mask broadcastable against
    (B, H, Tq, Tk); it takes the plain version. See the module docstring
    for routing.
    """
    global _LAST_PATH
    if mask is not None or not use_flash or _FORCE_PATH == "torch":
        _LAST_PATH = "torch"
        return attention_torch(q, k, v, mask, causal=causal, scale=scale,
                               valid_length=valid_length)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError(f"attention: q, k, v must be 4-D (B, H, T, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[-1] > _MAX_D:
        if _FORCE_PATH == "cuda" or (_FORCE_PATH is None and q.is_cuda):
            raise MXNetError(f"attention: head_dim {q.shape[-1]} > {_MAX_D}"
                             " is not taken by the flash kernels; pass "
                             "use_flash=False for the plain version")
        _LAST_PATH = "torch"
        return attention_torch(q, k, v, None, causal=causal, scale=scale,
                               valid_length=valid_length)
    return _FlashCore.apply(q, k, v, valid_length, causal, scale)
