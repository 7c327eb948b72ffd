"""Decode attention: one query timestep over the KV ring, on Hopper.

Counterpart of ``mxnet_tpu/ops/pallas/decode_attention.py``. The serving
decode step (``Generator``'s T = 1 call) runs every layer's attention
through :func:`decode_attention`, which launches the hand-written CUDA
kernel ``mxnet_tpu_torch/csrc/decode_attention.cu`` (the port of the TPU
kernel ``_decode_kernel``). :func:`decode_attention_torch` is the plain
PyTorch version of the same function, the counterpart of the JAX
package's fused-einsum ``_xla_decode``.

Routing depends only on where the tensors live and on their shapes, never
on their values:

* CUDA tensors at T == 1: the kernel, or an error. The wrapper checks
  device, dtypes, contiguity, ``H % KV == 0`` and ``D <= 256`` and raises
  on anything else; nothing falls back to the plain version.
* CUDA tensors at T > 1 (prefill): the plain version, as the JAX package
  routes T > 1 to ``_xla_decode``.
* CPU tensors: the plain version.

``force_path("torch")`` takes the plain version for CUDA tensors too (the
yardstick the kernel is held against on the card); ``force_path("cuda")``
insists on the kernel and raises for CPU tensors. ``last_path()`` says
which version the last call took, and ``launch_count()`` counts the
kernel calls the card ran (one per call, the combine pass included), so a
run can show that it went through the kernel. A call made while a CUDA
graph is being captured only records the launch: it counts in
``captured_count()`` instead, and whoever replays the graph adds the
launches it holds with ``count_replays(n)`` (``serve.engine.GraphSession``
does), so the count stays what the card executed.

Layout: GQA is native. ``k``/``v`` are the *unexpanded* (B, KV, S, D)
rings, f32 or int8 with (B, KV, S) f32 ``k_scale``/``v_scale``; the G =
H // KV query heads of a group share each K/V tile. ``start_pos`` (B,)
int32 stays on the device and is read by the kernel, so one launch
configuration serves every position.

The kernel splits each row's live positions across ``n_split`` blocks
(flash-decoding) and merges their partials in split order in a second
kernel. :func:`split_plan` picks ``n_split`` from the shapes and the SM
count alone, so nothing is read back from the device and one call can be
captured in a CUDA graph and replayed at every position.
:func:`decode_attention_split_torch` is the plain PyTorch mirror of that
split and merge, for the tests.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import torch

from ...base import MXNetError

_NEG_INF = -1e30  # finite "minus infinity": keeps fully-masked rows NaN-free
_BLOCK = 32       # KV positions per tile of the CUDA kernel (kTile)
_GROUP = 4        # query heads one block carries (kGroup)
_MAX_D = 256
# a split grid aims for at least this many blocks a SM: chip_smoke.py's
# split-aim sweep found 1 faster than 2 and 4 summed over a generate's
# launches (at long rings 4 is faster; see PERF.md)
BLOCKS_PER_SM = 1

_LAST_PATH = None  # "cuda" | "torch": the version the last call took
_FORCE_PATH = None
_LAUNCHES = 0     # launches the card ran: eager calls and graph replays
_CAPTURED = 0     # launches recorded into CUDA graphs while capturing
# the counts are bumped from every serving thread (fleet flushers, engine
# schedulers), so updates take this lock: a bare `+=` can lose one
_COUNT_LOCK = threading.Lock()
_LIB = None
_SM_COUNT = {}  # device index -> multiprocessors


def natural_block() -> int:
    """The CUDA kernel's KV tile width (``kTile`` in the source): a row's
    work is split in whole tiles and stops at the tile holding
    ``start_pos``, so a page of this many positions is the unit of work a
    row pays for."""
    return _BLOCK


def force_path(path) -> None:
    """Override routing: ``None`` (by device and shape), ``"torch"`` (the
    plain version, on any device) or ``"cuda"`` (the kernel; raises for CPU
    tensors)."""
    global _FORCE_PATH
    if path not in (None, "torch", "cuda"):
        raise ValueError(f"force_path: {path!r} not in (None,'torch','cuda')")
    _FORCE_PATH = path


def forced_path():
    """The routing override :func:`force_path` set (``None`` when routing
    goes by device and shape). A captured CUDA graph keeps the route it
    was captured on, so graph owners key their graphs by it."""
    return _FORCE_PATH


def last_path():
    return _LAST_PATH


def launch_count() -> int:
    """Kernel launches the card ran since import (or the last reset):
    eager calls plus the launches of replayed graphs
    (:func:`count_replays`)."""
    return _LAUNCHES


def reset_launch_count() -> None:
    global _LAUNCHES
    with _COUNT_LOCK:
        _LAUNCHES = 0


def captured_count() -> int:
    """Kernel launches recorded into CUDA graphs since import: a graph
    owner reads it before and after a capture to learn how many launches
    one replay of that graph makes."""
    return _CAPTURED


def count_replays(n) -> None:
    """Add ``n`` launches run by a graph replay to :func:`launch_count`."""
    global _LAUNCHES
    with _COUNT_LOCK:
        _LAUNCHES += int(n)


def _widen(x, x_scale):
    """A ring as f32, an int8 one scaled per position."""
    xf = x.to(torch.float32)
    return xf if x_scale is None else xf * x_scale[..., None].to(torch.float32)


def decode_attention_torch(q, k, v, start_pos, scale=None, k_scale=None,
                           v_scale=None):
    """Plain PyTorch decode attention, any T (the counterpart of
    ``_xla_decode``): grouped-heads attention over the ring with position
    ``s`` attending iff ``s <= start_pos[b] + t``, int8 rings dequantized
    inline."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    kf, vf = _widen(k, k_scale), _widen(v, v_scale)
    qg = q.to(torch.float32).reshape(b, kv, g, t, d)
    scores = torch.einsum("bngtd,bnsd->bngts", qg, kf) * sc
    pos = (start_pos.to(device=q.device, dtype=torch.int32)[:, None]
           + torch.arange(t, dtype=torch.int32, device=q.device))
    valid = (torch.arange(s, dtype=torch.int32, device=q.device)[None, None, :]
             <= pos[:, :, None])                                   # (B, T, S)
    # masked_fill takes the fill as a kernel argument: no host-to-device
    # copy, so the plain version can be captured in a CUDA graph too
    scores = scores.masked_fill(~valid[:, None, None], _NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngts,bnsd->bngtd", w, vf)
    return out.reshape(b, h, t, d).to(q.dtype)


def _shares(n, n_split):
    """[start, end) positions of each split's share of ``n`` live
    positions: equal counts of whole tiles, the last tile ragged, trailing
    splits empty where there are fewer tiles than splits (the kernel's
    arithmetic)."""
    tiles = -(-n // _BLOCK)
    per = -(-tiles // n_split) * _BLOCK
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(n_split)]


def decode_attention_split_torch(q, k, v, start_pos, n_split, scale=None,
                                 k_scale=None, v_scale=None):
    """Plain PyTorch mirror of the CUDA kernel's split and merge at T == 1:
    each of ``n_split`` splits of a row attends over its share of the live
    positions (:func:`_shares`) and yields (m, l, acc), the running max,
    the sum of exp(score - m) and the unnormalised P.V; the splits are then
    merged in split order, skipping empty ones (l == 0), and a row whose
    sum stays 0 gives zeros. For the tests; nothing on the serving path
    calls it."""
    b, h, t, d = q.shape
    if t != 1:
        raise ValueError(f"decode_attention_split_torch: T must be 1, got {t}")
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    kf, vf = _widen(k, k_scale), _widen(v, v_scale)
    qg = q.to(torch.float32).reshape(b, kv, g, d)
    scores = torch.einsum("bngd,bnsd->bngs", qg, kf) * sc
    pos = torch.arange(s)
    share = torch.zeros(b, n_split, s, dtype=torch.bool)
    for r, sp in enumerate(start_pos.detach().cpu().tolist()):
        for i, (lo, hi) in enumerate(_shares(min(max(sp + 1, 0), s),
                                             n_split)):
            share[r, i] = (pos >= lo) & (pos < hi)
    share = share.to(q.device)[:, :, None, None, :]      # (B, NS, 1, 1, S)
    masked = torch.where(share, scores[:, None], torch.tensor(
        _NEG_INF, dtype=torch.float32, device=q.device))  # (B, NS, KV, G, S)
    m = masked.max(-1).values
    p = torch.where(share, torch.exp(masked - m[..., None]),
                    torch.zeros((), device=q.device))
    l = p.sum(-1)
    acc = torch.einsum("bings,bnsd->bingd", p, vf)
    live = l > 0
    mb = torch.where(live, m, torch.full_like(m, _NEG_INF)).max(1).values
    wt = torch.where(live, torch.exp(m - mb[:, None]), torch.zeros_like(m))
    lb = torch.zeros_like(mb)
    ab = torch.zeros(b, kv, g, d, device=q.device)
    for i in range(n_split):                               # in split order
        lb = lb + wt[:, i] * l[:, i]
        ab = ab + wt[:, i, ..., None] * acc[:, i]
    out = torch.where(lb[..., None] > 0,
                      ab / torch.where(lb > 0, lb, 1.0)[..., None],
                      torch.zeros_like(ab))
    return out.reshape(b, h, 1, d).to(q.dtype)


class SplitPlan(NamedTuple):
    """How one launch covers the rings: ``groups`` blocks of up to 4 query
    heads per (batch row, KV head), ``splits`` shares of each row's live
    positions, ``tiles`` of ``natural_block()`` positions in the ring, and
    ``workspace_bytes`` of f32 partials (0 at one split, where the kernel
    writes the output itself)."""
    groups: int
    splits: int
    tiles: int
    grid: tuple
    workspace_bytes: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def split_plan(b, kv, s, g, d, sm_count) -> SplitPlan:
    """The grid of one launch, from shapes and the SM count alone (never
    from ``start_pos``): one split where the (batch row, KV head, head
    group) blocks alone give each of the card's ``sm_count`` SMs a block;
    else the fewest splits that give ``BLOCKS_PER_SM`` blocks a SM, but no
    more splits than the ring has tiles."""
    groups = -(-g // _GROUP)
    rows = b * kv * groups
    tiles = max(1, -(-s // _BLOCK))
    splits = 1
    if rows < sm_count:
        splits = min(tiles, -(-sm_count * BLOCKS_PER_SM // rows))
    return SplitPlan(groups, splits, tiles, (rows, splits),
                     _workspace_bytes(b * kv * g, splits, d))


def _workspace_bytes(bh, splits, d) -> int:
    """f32 partials (m, l and D accumulators) of ``bh`` (batch row, head)
    rows at ``splits`` splits; none at one split."""
    return bh * splits * (d + 2) * 4 if splits > 1 else 0


def _sm_count(dev) -> int:
    n = _SM_COUNT.get(dev.index)
    if n is None:
        n = _SM_COUNT[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load

        lib = load("decode_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mxtt_decode_attention.argtypes = ([ptr] * 9 + [i32] * 6
                                              + [ctypes.c_float, i32, i32,
                                                 ptr])
        lib.mxtt_decode_attention.restype = i32
        lib.mxtt_decode_attention_combine.argtypes = [ptr] * 3 + [i32] * 3 \
            + [ptr]
        lib.mxtt_decode_attention_combine.restype = i32
        for name in ("block", "group"):
            getattr(lib, f"mxtt_decode_attention_{name}").argtypes = []
            getattr(lib, f"mxtt_decode_attention_{name}").restype = i32
        lib.mxtt_decode_attention_smem_bytes.argtypes = [i32, i32]
        lib.mxtt_decode_attention_smem_bytes.restype = ctypes.c_longlong
        lib.mxtt_error_string.argtypes = [i32]
        lib.mxtt_error_string.restype = ctypes.c_char_p
        got = (lib.mxtt_decode_attention_block(),
               lib.mxtt_decode_attention_group())
        if got != (_BLOCK, _GROUP):
            raise MXNetError(f"decode_attention.cu tiles {got[0]} positions "
                             f"and {got[1]} heads a block, but the wrapper "
                             f"assumes {_BLOCK} and {_GROUP}")
        _LIB = lib
    return _LIB


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _lib()


def _check_launch(q, k, v, start_pos, k_scale, v_scale):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("decode_attention: q, k, v must be 4-D "
                         f"(got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)})")
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    if t != 1:
        raise MXNetError(f"decode_attention kernel: T must be 1, got {t}")
    if tuple(k.shape) != (b, kv, s, d) or tuple(v.shape) != (b, kv, s, d):
        raise MXNetError(f"decode_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise MXNetError(f"decode_attention: {h} heads not a multiple of "
                         f"{kv} KV heads")
    if d > _MAX_D:
        raise MXNetError(f"decode_attention kernel: head_dim {d} > {_MAX_D}")
    if s == 0:
        raise MXNetError("decode_attention: empty KV ring")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise MXNetError("decode_attention: pass both k_scale and v_scale "
                         "or neither")
    tensors = [("q", q), ("k", k), ("v", v), ("start_pos", start_pos)]
    if quant:
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, x in tensors:
        if x.device != q.device:
            raise MXNetError(f"decode_attention: {name} on {x.device}, q on "
                             f"{q.device}")
        if not x.is_contiguous():
            raise MXNetError(f"decode_attention: {name} is not contiguous")
    if q.dtype != torch.float32:
        raise MXNetError(f"decode_attention kernel: q must be float32, got "
                         f"{q.dtype}")
    ring = torch.int8 if quant else torch.float32
    if k.dtype != ring or v.dtype != ring:
        raise MXNetError(f"decode_attention kernel: k/v must be {ring} "
                         f"{'with' if quant else 'without'} scales, got "
                         f"{k.dtype}/{v.dtype}")
    if quant:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(x.shape) != (b, kv, s) or x.dtype != torch.float32:
                raise MXNetError(f"decode_attention: {name} must be float32 "
                                 f"{(b, kv, s)}, got {x.dtype} "
                                 f"{tuple(x.shape)}")
    if tuple(start_pos.shape) != (b,) or start_pos.dtype != torch.int32:
        raise MXNetError(f"decode_attention: start_pos must be int32 ({b},), "
                         f"got {start_pos.dtype} {tuple(start_pos.shape)}")


def _launch(q, k, v, start_pos, scale, k_scale, v_scale, n_split=None):
    """Launch the kernel (and, at more than one split, the combine); the
    split count is ``split_plan``'s unless ``n_split`` forces one."""
    global _LAUNCHES, _CAPTURED
    _check_launch(q, k, v, start_pos, k_scale, v_scale)
    lib = _lib()
    b, h, _, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    plan = split_plan(b, kv, s, g, d, _sm_count(q.device))
    if n_split is not None:
        plan = plan._replace(splits=n_split, grid=(plan.grid[0], n_split),
                             workspace_bytes=_workspace_bytes(b * h, n_split,
                                                              d))
    quant = k_scale is not None
    elem = k.element_size()
    vec = int((d * elem) % 16 == 0 and k.data_ptr() % 16 == 0
              and v.data_ptr() % 16 == 0)
    out = torch.empty_like(q)
    ws_ml = ws_acc = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                         device=q.device)
        ws_ml, ws_acc = ws.split([b * h * plan.splits * 2,
                                  b * h * plan.splits * d])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtt_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            start_pos.data_ptr(), out.data_ptr(),
            None if ws_ml is None else ws_ml.data_ptr(),
            None if ws_acc is None else ws_acc.data_ptr(),
            b, kv, s, d, g, plan.splits, float(scale), int(quant), vec,
            stream)
        what = "decode_attention kernel"
        if err == 0 and plan.splits > 1:
            what = "decode_attention combine kernel"
            err = lib.mxtt_decode_attention_combine(
                ws_ml.data_ptr(), ws_acc.data_ptr(), out.data_ptr(), b * h,
                plan.splits, d, stream)
    if err != 0:
        raise MXNetError(
            f"{what} launch failed: {lib.mxtt_error_string(err).decode()} "
            f"(cudaError {err}; q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"{k.dtype}, vec {vec}, plan {plan}, shared memory "
            f"{lib.mxtt_decode_attention_smem_bytes(d, int(quant))} B)")
    capturing = torch.cuda.is_current_stream_capturing()
    with _COUNT_LOCK:
        if capturing:
            _CAPTURED += 1
        else:
            _LAUNCHES += 1
    return out


def decode_attention(q, k, v, start_pos, scale=None, k_scale=None,
                     v_scale=None):
    """Attention for the serving decode step.

    q: (B, H, T, D); k/v: (B, KV, S, D) *unexpanded* GQA rings (f32, or
    int8 with (B, KV, S) ``k_scale``/``v_scale``); start_pos: (B,) int32.
    Position ``s`` attends iff ``s <= start_pos[b] + t``. Returns
    (B, H, T, D) in q's dtype. See the module docstring for routing.
    """
    global _LAST_PATH
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _FORCE_PATH == "cuda" or (_FORCE_PATH is None and q.is_cuda
                                 and q.shape[2] == 1):
        if not q.is_cuda:
            raise MXNetError("force_path('cuda'): the decode-attention "
                             f"kernel needs CUDA tensors, got {q.device}")
        out = _launch(q, k, v, start_pos, sc, k_scale, v_scale)
        _LAST_PATH = "cuda"
        return out
    _LAST_PATH = "torch"
    return decode_attention_torch(q, k, v, start_pos, sc, k_scale, v_scale)
