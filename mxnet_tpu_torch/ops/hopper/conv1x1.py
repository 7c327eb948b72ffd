"""Fused channels-last 1x1-conv pair on Hopper.

Counterpart of ``mxnet_tpu/ops/pallas/conv1x1.py``. :func:`conv1x1_pair`
computes, per row of ``x`` flattened to (M, C1)::

    h   = relu(x @ w1 * scale1 + bias1 [+ residual])   # rounded to x.dtype
    y   = relu(h @ w2 * scale2 + bias2)                 # rounded to x.dtype

and returns ``y`` (and ``h`` as ``mid`` with ``return_mid=True``). Both
products accumulate in f32, the affines are f32, and the residual is cast to
``x.dtype`` before it is widened. On CUDA tensors it launches the
hand-written kernel of ``mxnet_tpu_torch/csrc/conv1x1.cu`` (the port of the
TPU kernel's three bodies ``_kernel``, ``_kernel_res`` and
``_kernel_res2``); on CPU tensors it takes :func:`conv1x1_pair_torch`, the
plain version. Nothing falls back: a CUDA call the kernel does not take
raises.

The TPU's facts are not copied: ``block_rows`` is accepted and changes
nothing (the kernel picks its own row tile and masks the ragged edge, so
there is no padding copy), outputs are fresh tensors (no
``input_output_aliases``), and the affines are (C,) vectors, not the (1, C)
blocks VMEM asks for. Where row tiles alone give the card fewer blocks than
it has SMs, :func:`split_plan` splits Cm across blocks: each writes a
partial y to an f32 workspace, and a second kernel sums the partials in a
fixed order (no atomics: two calls give bitwise equal outputs).

``last_path()`` says which version the last call took ("cuda" | "torch");
``launch_count()`` counts launches by variant (``KERNELS``: no residual,
residual, residual and mid), of both dtypes or of one, bumped only after a
launch returns ``cudaSuccess``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...base import MXNetError

KERNELS = ("pair", "pair_res", "pair_res_mid")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LAST_PATH = None  # "cuda" | "torch": the version the last call took
_FORCE_PATH = None
_LAUNCHES = {(k, d): 0 for k in KERNELS for d in _DTYPES}
_LIB = None
_SM_COUNT = {}  # device index -> multiprocessors

CHUNK = 64            # Cm columns of one chunk: a slice holds whole chunks
TILES = {64: 64, 128: 64, 256: 64, 512: 32}  # a block's y columns -> its rows
BLOCKS_PER_SM = 2     # a split grid aims for at least this many blocks a SM


def force_path(path) -> None:
    """Override routing: ``None`` (by device), ``"torch"`` (the plain
    version, on any device) or ``"cuda"`` (the kernel; raises for CPU
    tensors)."""
    global _FORCE_PATH
    if path not in (None, "torch", "cuda"):
        raise ValueError(f"force_path: {path!r} not in (None,'torch','cuda')")
    _FORCE_PATH = path


def last_path():
    return _LAST_PATH


def launch_count(dtype=None) -> dict:
    """Kernel launches since import (or the last reset), by variant; of
    one dtype (float32 or bfloat16) only when ``dtype`` is given."""
    return {k: sum(n for (kk, d), n in _LAUNCHES.items()
                   if kk == k and dtype in (None, d)) for k in KERNELS}


def reset_launch_count() -> None:
    for key in _LAUNCHES:
        _LAUNCHES[key] = 0


def _affine(v, n, fill, device):
    """A (n,) f32 per-channel affine: ``fill`` where ``v`` is None."""
    if v is None:
        return torch.full((n,), fill, dtype=torch.float32, device=device)
    return torch.broadcast_to(torch.as_tensor(v, device=device), (n,)).to(
        torch.float32).contiguous()


# -- plain version ------------------------------------------------------------


def conv1x1_pair_torch(x, w1, w2, scale1=None, bias1=None, scale2=None,
                       bias2=None, residual=None, *, return_mid=False):
    """Plain PyTorch version of the kernel: the same arithmetic, op by op,
    with the (M, Cm) mid materialized. Returns ``y`` shaped
    ``(*lead, Cout)``, or ``(y, mid)`` with ``return_mid=True``."""
    if return_mid and residual is None:
        raise ValueError("return_mid requires residual")
    c1, cm = w1.shape
    cout = w2.shape[1]
    lead = x.shape[:-1]
    f32 = torch.float32
    dev = x.device
    h = torch.matmul(x.reshape(-1, c1).to(f32), w1.to(f32))
    h = h * _affine(scale1, cm, 1.0, dev) + _affine(bias1, cm, 0.0, dev)
    if residual is not None:
        h = h + residual.reshape(-1, cm).to(x.dtype).to(f32)
    h = torch.relu(h).to(x.dtype)
    y = torch.matmul(h.to(f32), w2.to(f32))
    y = y * _affine(scale2, cout, 1.0, dev) + _affine(bias2, cout, 0.0, dev)
    y = torch.relu(y).to(x.dtype).reshape(*lead, cout)
    if return_mid:
        return y, h.reshape(*lead, cm)
    return y


# -- the grid ------------------------------------------------------------------


class SplitPlan(NamedTuple):
    """How one launch covers (M, Cout) and splits Cm: a tile of
    ``block_rows`` x ``block_cols`` of y a block, ``slices`` slices of
    ``slice_cols`` Cm columns each (the last may be narrower), ``grid`` the
    (row tiles, Cout slabs, slices) of blocks, ``workspace_bytes`` the f32
    partial y (0 at one slice)."""
    block_rows: int
    block_cols: int
    slices: int
    slice_cols: int
    grid: tuple
    workspace_bytes: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _block_tile(cout: int) -> tuple:
    """(rows, columns) of a block's tile of y: the narrowest of ``TILES``
    that covers Cout, else 512-column slabs (at most 80 accumulators a
    thread, h's and y's)."""
    cols = next((c for c in TILES if cout <= c), 512)
    return TILES[cols], cols


def split_plan(m, cm, cout, sm_count) -> SplitPlan:
    """The grid of one launch: one slice where row tiles and Cout slabs
    alone give each of the card's ``sm_count`` SMs a block; else the fewest
    Cm slices (whole 64-wide chunks, none empty) that give ``BLOCKS_PER_SM``
    blocks a SM, or one slice a chunk where even that gives fewer."""
    bm, bn = _block_tile(cout)
    grid = (-(-m // bm), -(-cout // bn))
    tiles = grid[0] * grid[1]
    chunks = -(-cm // CHUNK)
    per = chunks
    if tiles < sm_count:
        for s in range(2, chunks + 1):
            per = -(-chunks // s)
            if tiles * -(-chunks // per) >= sm_count * BLOCKS_PER_SM:
                break
    slices = -(-chunks // per)  # no empty slice
    return SplitPlan(bm, bn, slices, per * CHUNK, (*grid, slices),
                     slices * m * cout * 4 if slices > 1 else 0)


def _sm_count(dev) -> int:
    n = _SM_COUNT.get(dev.index)
    if n is None:
        n = _SM_COUNT[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


# -- the CUDA kernel ------------------------------------------------------------


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load

        lib = load("conv1x1")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mxtt_conv1x1_pair.argtypes = [i32, i32] + [ptr] * 11 + [i32] * 7 \
            + [ptr]
        lib.mxtt_conv1x1_pair.restype = i32
        lib.mxtt_conv1x1_pair_reduce.argtypes = [i32] + [ptr] * 4 + [i32] * 3 \
            + [ptr]
        lib.mxtt_conv1x1_pair_reduce.restype = i32
        lib.mxtt_conv1x1_smem_bytes.argtypes = [i32] * 4 \
            + [ctypes.POINTER(i32)] * 2
        lib.mxtt_conv1x1_smem_bytes.restype = ctypes.c_longlong
        lib.mxtt_conv1x1_error_string.argtypes = [i32]
        lib.mxtt_conv1x1_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _lib()


def smem_layout(dtype, plan, c1) -> dict:
    """The kernel's shared-memory layout for a block of ``plan`` at ``c1``
    input channels: its bytes, whether the x tile stays resident, and the
    ring's stages (builds the library)."""
    xres, stages = ctypes.c_int(), ctypes.c_int()
    nbytes = _lib().mxtt_conv1x1_smem_bytes(
        _DTYPES[dtype], plan.block_rows, plan.block_cols, c1,
        ctypes.byref(xres), ctypes.byref(stages))
    return {"smem_bytes": nbytes, "x_resident": bool(xres.value),
            "stages": stages.value}


def _use_kernel(x):
    """True to launch the kernel for ``x``; raises for a CPU tensor under
    ``force_path("cuda")``."""
    global _LAST_PATH
    if _FORCE_PATH == "cuda" or (_FORCE_PATH is None and x.is_cuda):
        if not x.is_cuda:
            raise MXNetError("force_path('cuda'): the conv1x1_pair kernel "
                             f"needs CUDA tensors, got {x.device}")
        _LAST_PATH = "cuda"
        return True
    _LAST_PATH = "torch"
    return False


def _check(x, w1, w2, residual):
    if x.dtype not in _DTYPES:
        raise MXNetError(f"conv1x1_pair kernel: x must be float32 or "
                         f"bfloat16, got {x.dtype}")
    if w1.dim() != 2 or w2.dim() != 2 or w1.shape[1] != w2.shape[0] \
            or x.dim() < 1 or x.shape[-1] != w1.shape[0]:
        raise MXNetError(f"conv1x1_pair: shapes x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} do not "
                         "chain as (..., C1) @ (C1, Cm) @ (Cm, Cout)")
    operands = [("x", x), ("w1", w1), ("w2", w2)]
    if residual is not None:
        want = (*x.shape[:-1], w1.shape[1])
        if tuple(residual.shape) != want:
            raise MXNetError(f"conv1x1_pair: residual {tuple(residual.shape)}"
                             f", want {want}")
        operands.append(("residual", residual))
    for label, t in operands:
        if t.device != x.device:
            raise MXNetError(f"conv1x1_pair: {label} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise MXNetError(f"conv1x1_pair: {label} is not contiguous")
        if label in ("w1", "w2") and t.dtype != x.dtype:
            raise MXNetError(f"conv1x1_pair kernel: {label} is {t.dtype}, x "
                             f"is {x.dtype}")
    if 0 in (w1.shape[0], w1.shape[1], w2.shape[1]):
        raise MXNetError(f"conv1x1_pair kernel: empty channels, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if max(x.numel(), w1.numel(), w2.numel()) >= 2 ** 31:
        raise MXNetError("conv1x1_pair kernel: an operand has 2**31 or more "
                         "elements")


def _raise_if(err, which, x, w1, w2, plan):
    """Raise :class:`MXNetError` for a launch that returned ``err`` != 0."""
    if err == 0:
        return
    lib = _lib()
    layout = smem_layout(x.dtype, plan, w1.shape[0])
    raise MXNetError(
        f"conv1x1_pair{which} kernel launch failed: "
        f"{lib.mxtt_conv1x1_error_string(err).decode()} (cudaError {err}; x "
        f"{tuple(x.shape)} {x.dtype}, w1 {tuple(w1.shape)}, w2 "
        f"{tuple(w2.shape)}, {plan.block_rows} x {plan.block_cols} tiles, "
        f"grid {plan.grid}, "
        f"{plan.slices} Cm slices, workspace {plan.workspace_bytes} B, shared "
        f"memory {layout['smem_bytes']} B)")


def conv1x1_pair(x, w1, w2, scale1=None, bias1=None, scale2=None,
                 bias2=None, residual=None, *, block_rows=1024,
                 return_mid=False):
    """``relu(a2(relu(a1(x @ w1) [+ residual]) @ w2))`` with the mid kept
    on chip: the kernel on CUDA tensors, the plain version on CPU tensors.

    x: (..., C1) channels-last; w1: (C1, Cm); w2: (Cm, Cout), of x's dtype
    (float32 or bfloat16). scale/bias: optional (Cm,)/(Cout,) per-channel
    affines (folded BN), 1 and 0 when None. residual: optional (..., Cm),
    added after the first affine, before its relu. return_mid (requires
    residual): also return the post-residual mid -> ``(y, mid)``.
    ``block_rows`` is the reference's and changes nothing here.
    """
    del block_rows  # the kernel picks its own row tile
    if return_mid and residual is None:
        raise ValueError("return_mid requires residual")
    if not _use_kernel(x):
        return conv1x1_pair_torch(x, w1, w2, scale1, bias1, scale2, bias2,
                                  residual, return_mid=return_mid)
    if residual is not None:
        residual = residual.to(x.dtype)
    _check(x, w1, w2, residual)
    c1, cm = w1.shape
    cout = w2.shape[1]
    lead = x.shape[:-1]
    m = x.numel() // c1
    dev = x.device
    affines = [_affine(scale1, cm, 1.0, dev), _affine(bias1, cm, 0.0, dev),
               _affine(scale2, cout, 1.0, dev),
               _affine(bias2, cout, 0.0, dev)]
    out = torch.empty((*lead, cout), dtype=x.dtype, device=dev)
    mid = (torch.empty((*lead, cm), dtype=x.dtype, device=dev)
           if return_mid else None)
    if m:  # an empty batch launches nothing
        variant = 0 if residual is None else 2 if return_mid else 1
        plan = split_plan(m, cm, cout, _sm_count(dev))
        ws = (torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                          device=dev) if plan.slices > 1 else None)
        lib = _lib()
        dt = _DTYPES[x.dtype]
        ptrs = [x, residual, w1, w2, *affines, mid, out, ws]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mxtt_conv1x1_pair(
                dt, variant,
                *[None if t is None else t.data_ptr() for t in ptrs],
                m, c1, cm, cout, plan.block_rows, plan.block_cols,
                plan.slices, stream)
            _raise_if(err, "", x, w1, w2, plan)
            if ws is not None:
                err = lib.mxtt_conv1x1_pair_reduce(
                    dt, ws.data_ptr(), affines[2].data_ptr(),
                    affines[3].data_ptr(), out.data_ptr(), m, cout,
                    plan.slices, stream)
                _raise_if(err, " reduce", x, w1, w2, plan)
        _LAUNCHES[KERNELS[variant], x.dtype] += 1
    if return_mid:
        return out, mid
    return out
