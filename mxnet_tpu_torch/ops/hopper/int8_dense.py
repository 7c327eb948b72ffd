"""int8 x int8 fully-connected layer on Hopper.

Counterpart of the accelerator branch of the JAX package's
``quantized_dense`` (``mxnet_tpu/ops/nn.py``, ``int8_dot``), which the TPU
ran as XLA's int8 dot on its matrix unit; there is no ``pallas_call`` to
port. :func:`int8_dense` computes, per row of ``x`` flattened to (M, U)::

    sx  = max(max|x| / 127, 1e-8)                      # (M,) f32
    xq  = clip(round_half_even(x / sx), -127, 127)     # int8
    acc = xq @ qweight.T                               # int32, exact
    out = (acc * sx) * scale [+ bias]                  # f32, op by op

On CUDA tensors it launches the hand-written kernels of
``mxnet_tpu_torch/csrc/int8_dense.cu``: the row quantization, one of three
product kernels with the rescale fused and, where the plan splits U across
blocks, the in-order sum of the int32 partials. :func:`route_for` names the
product kernel: on a weight whose rows are a multiple of 16 bytes and
which starts 16-byte aligned, decode and verify rows (M <= 32) take the
weight-streaming ``decode`` kernel (grid: :func:`decode_plan`; its launch,
and the sum's, chained to the quantization by programmatic dependent
launch) and prefill rows the ``wgmma`` + TMA kernel (grid:
:func:`wgmma_plan`); a ragged or misaligned weight at any M takes the
``mma_sync`` kernel (grid: :func:`split_plan`). The quantization runs on
:func:`quantize_cluster` blocks a row. On CPU tensors it takes
:func:`int8_dense_torch`, the plain version. Nothing falls back: a CUDA
call the kernels do not take raises. The plain version takes its product
in float64, which is exact here (each partial sum stays below
127**2 * U < 2**53), so every kernel equals it bit for bit.

``force_path("torch")`` takes the plain version for CUDA tensors too (the
yardstick the kernel is held against on the card); ``force_path("cuda")``
insists on the kernel and raises for CPU tensors. ``last_path()`` says
which version the last call took, and ``launch_count()`` counts the calls
the card ran (one per call, whatever kernels it took); ``route_launches()``
splits the eager calls by product kernel. A call made while a
CUDA graph is being captured only records the launch: it counts in
``captured_count()``, and whoever replays the graph adds the launches it
holds with ``count_replays(n)`` (``serve.engine.GraphSession`` does).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from ...base import MXNetError

CHUNK = 64   # bytes of U a chunk of the product (the kernel's kBK)
# a block's rows -> its output channels
TILES = {16: 64, 64: 128, 128: 128}
# a split grid aims for at least this many blocks a SM, by block rows:
# of 1, 2 and 4, the aim that gave one Llama-3-8B forward's products the
# least time on an H100 at M = 4, 256 and 1024
BLOCKS_PER_SM = {16: 2, 64: 2, 128: 1}

# the wgmma kernel: a block's rows (two consumer warpgroups of 64), the
# bytes of U a stage of its ring, its tile widths
WGMMA_ROWS = 128
WGMMA_CHUNK = 128
WGMMA_COLS = (128, 256)
# the decode kernel: output channels a block, bytes of U a chunk (its
# slices' unit), channel rows and bytes of U a stage (a stage row is one
# bulk copy), stages in its ring, the most rows it takes
DECODE_COLS = 64
DECODE_CHUNK = 128
DECODE_STAGE_ROWS = 16
DECODE_STAGE = 1024
DECODE_STAGES = 4
DECODE_ROWS = 32
# a decode block's slice of xq in shared memory at most: with the ring's
# 65 KB, two blocks fit an SM
DECODE_XQ_BYTES = 40 * 1024
# a decode slice holds at least this many chunks where U has them
DECODE_MIN_CHUNKS = 2
# what decode_plan charges a block beyond its weight bytes (its start, the
# xq copy, the epilogue), in bytes of weight streamed in that time
DECODE_BLOCK_BYTES = 16 * 1024
# the quantization: values a thread keeps in registers, its block's
# threads, the most blocks a row (a cluster)
QUANT_KEEP = 32
QUANT_THREADS = 256
QUANT_CLUSTER_MAX = 8
ROUTES = ("wgmma", "decode", "mma_sync")

_LAST_PATH = None  # "cuda" | "torch": the version the last call took
_FORCE_PATH = None
_LAUNCHES = 0     # calls the card ran: eager calls and graph replays
_CAPTURED = 0     # calls recorded into CUDA graphs while capturing
_ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)  # eager calls by product kernel
_ROW_LAUNCHES = {}  # eager calls by (product kernel, rows M)
_COUNT_LOCK = threading.Lock()
_LIB = None
_SM_COUNT = {}  # device index -> multiprocessors


def force_path(path) -> None:
    """Override routing: ``None`` (by device), ``"torch"`` (the plain
    version, on any device) or ``"cuda"`` (the kernel; raises for CPU
    tensors)."""
    global _FORCE_PATH
    if path not in (None, "torch", "cuda"):
        raise ValueError(f"force_path: {path!r} not in (None,'torch','cuda')")
    _FORCE_PATH = path


def forced_path():
    """The routing override :func:`force_path` set (``None`` when routing
    goes by device). Graph owners key their graphs by it."""
    return _FORCE_PATH


def last_path():
    return _LAST_PATH


def launch_count() -> int:
    """Calls the card ran since import (or the last reset): eager calls
    plus the calls of replayed graphs (:func:`count_replays`)."""
    return _LAUNCHES


def reset_launch_count() -> None:
    """Zero :func:`launch_count`, :func:`route_launches` and
    :func:`row_launches`."""
    global _LAUNCHES
    with _COUNT_LOCK:
        _LAUNCHES = 0
        for r in ROUTES:
            _ROUTE_LAUNCHES[r] = 0
        _ROW_LAUNCHES.clear()


def route_launches() -> dict:
    """Eager calls since import (or the last reset) by the product kernel
    they ran: ``"wgmma"``, ``"decode"`` or ``"mma_sync"``. Calls captured
    into CUDA graphs and their replays count in :func:`captured_count` and
    :func:`launch_count` only."""
    with _COUNT_LOCK:
        return dict(_ROUTE_LAUNCHES)


def row_launches() -> dict:
    """The eager calls of :func:`route_launches` by (product kernel, rows
    M of the call), only the pairs that ran."""
    with _COUNT_LOCK:
        return dict(_ROW_LAUNCHES)


def captured_count() -> int:
    """Calls recorded into CUDA graphs since import."""
    return _CAPTURED


def count_replays(n) -> None:
    """Add ``n`` calls run by a graph replay to :func:`launch_count`."""
    global _LAUNCHES
    with _COUNT_LOCK:
        _LAUNCHES += int(n)


# -- plain version ------------------------------------------------------------


def int8_scale(amax):
    """Symmetric int8 scale ``max(amax / 127, 1e-8)`` of rows whose largest
    magnitude is ``amax``. The divisor is a tensor on ``amax``'s device:
    PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, one ulp away from the true quotient that ``jnp``, the CPU
    and the kernel give. It is filled on the device (``new_full``), not
    copied from the host, so the op can be captured in a CUDA graph."""
    return torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)


def quantize_rows_torch(x):
    """Plain per-row symmetric quantization of ``x`` (M, U) f32: returns
    ``(xq, sx)``, (M, U) int8 and (M, 1) f32."""
    sx = int8_scale(torch.amax(torch.abs(x), dim=-1, keepdim=True))
    xq = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_dense_torch(x, qweight, scale, bias=None):
    """Plain PyTorch version of the kernel: the same quantization, the
    product in float64 (exact), then the f32 rescale op by op. ``x``
    (..., U) f32, ``qweight`` (O, U) int8, ``scale`` (O,) f32, ``bias``
    (O,) f32 or None; returns (..., O) f32."""
    u = qweight.shape[1]
    lead = x.shape[:-1]
    xq, sx = quantize_rows_torch(x.reshape(-1, u).to(torch.float32))
    acc = torch.matmul(xq.to(torch.float64), qweight.to(torch.float64).t())
    out = acc.to(torch.float32) * sx * scale
    if bias is not None:
        out = out + bias
    return out.reshape(*lead, qweight.shape[0])


# -- the grid ------------------------------------------------------------------


class SplitPlan(NamedTuple):
    """How one launch covers (M, O) and splits U: tiles of ``block_rows``
    x ``block_cols``, ``slices`` slices of ``chunks_per_slice`` chunks of U
    (64 bytes on the ``mma.sync`` kernel, 128 on wgmma and decode; the last
    slice may be shorter), ``grid`` the (O tiles, M tiles, slices) of
    blocks, ``workspace_bytes`` the int32 partials (0 at one slice). The
    decode kernel's block takes every row: ``block_rows`` is M rounded up
    to 8."""
    block_rows: int
    block_cols: int
    slices: int
    chunks_per_slice: int
    grid: tuple
    workspace_bytes: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def block_rows_for(m) -> int:
    """The row tile for ``m`` rows: 16 up to 32 rows (decode, the verify
    pass), 64 up to 256, else 128."""
    return 16 if m <= 32 else 64 if m <= 256 else 128


def padded_u(u) -> int:
    """U rounded up to whole chunks: the row pitch of the quantized x."""
    return -(-u // CHUNK) * CHUNK


@functools.lru_cache(maxsize=1024)
def split_plan(m, o, u, sm_count) -> SplitPlan:
    """The grid of one launch, from shapes and the SM count alone: one
    slice where the (M, O) tiles give ``BLOCKS_PER_SM`` blocks a SM; else
    the fewest slices of whole chunks (none empty) that do, or one chunk a
    slice where even that falls short."""
    bm = block_rows_for(m)
    bn = TILES[bm]
    grid = (-(-o // bn), -(-m // bm))
    chunks = padded_u(u) // CHUNK
    per = _chunks_per_slice(grid[0] * grid[1], chunks,
                            sm_count * BLOCKS_PER_SM[bm])
    slices = -(-chunks // per)  # no empty slice
    return SplitPlan(bm, bn, slices, per, (*grid, slices),
                     slices * m * o * 4 if slices > 1 else 0)


def _chunks_per_slice(tiles, chunks, aim) -> int:
    """All ``chunks`` in one slice where ``tiles`` blocks reach ``aim``;
    else the fewest slices of whole chunks that do, or one chunk a slice
    where even that falls short."""
    per = chunks
    if tiles < aim:
        for s in range(2, chunks + 1):
            per = -(-chunks // s)
            if tiles * -(-chunks // per) >= aim:
                break
    return per


def _bulk_readable(u, qweight_ptr) -> bool:
    """A weight TMA and bulk copies can read: rows a multiple of 16 bytes,
    the start 16-byte aligned."""
    return u % 16 == 0 and qweight_ptr % 16 == 0


def takes_wgmma(m, u, qweight_ptr) -> bool:
    """True where the wgmma kernel takes a CUDA call of ``m`` rows against
    a weight of ``u`` int8 columns at address ``qweight_ptr``: prefill rows
    (more than 32) on a weight TMA can read (rows a multiple of 16 bytes,
    the start 16-byte aligned)."""
    return m > DECODE_ROWS and _bulk_readable(u, qweight_ptr)


def route_for(m, u, qweight_ptr) -> str:
    """The product kernel of a CUDA call: ``"decode"`` for M <= 32 and
    ``"wgmma"`` for more rows on a weight whose rows are a multiple of 16
    bytes and which starts 16-byte aligned, ``"mma_sync"`` for a ragged or
    misaligned weight at any M."""
    if not _bulk_readable(u, qweight_ptr):
        return "mma_sync"
    return "decode" if m <= DECODE_ROWS else "wgmma"


@functools.lru_cache(maxsize=1024)
def decode_plan(m, o, u, sm_count) -> SplitPlan:
    """The decode kernel's grid, from shapes and the SM count alone. A
    block takes 64 output channels over one slice of U in whole 128-byte
    chunks, all M rows; a slice holds at most what fits
    ``DECODE_XQ_BYTES`` of xq (its rows rounded up to 8) and at least
    ``DECODE_MIN_CHUNKS`` chunks. Of those slice lengths it takes, first,
    one that gives every SM
    a block; then the least time an SM streams, reckoned as the blocks its
    fullest share holds (``ceil(blocks / sm_count)``) times a block's
    weight bytes plus ``DECODE_BLOCK_BYTES``; then the fewest slices (the
    least partial sums). Every slice is as long as the others but the
    last, and none is empty."""
    rows = 8 * -(-m // 8)
    tiles = -(-o // DECODE_COLS)
    chunks = -(-u // DECODE_CHUNK)
    longest = max(1, min(chunks, DECODE_XQ_BYTES // (rows * DECODE_CHUNK)))
    best = None
    for per in range(longest, min(longest, DECODE_MIN_CHUNKS) - 1, -1):
        slices = -(-chunks // per)
        if -(-chunks // slices) != per:  # the same slices, evened out
            continue
        blocks = tiles * slices
        cost = -(-blocks // sm_count) * (per * DECODE_CHUNK * DECODE_COLS
                                         + DECODE_BLOCK_BYTES)
        key = (blocks < sm_count, cost, slices)
        if best is None or key < best[0]:
            best = (key, per, slices)
    _, per, slices = best
    return SplitPlan(rows, DECODE_COLS, slices, per, (tiles, 1, slices),
                     slices * m * o * 4 if slices > 1 else 0)


@functools.lru_cache(maxsize=1024)
def quantize_cluster(m, u, sm_count) -> int:
    """The row quantization's blocks a row, from shapes and the SM count
    alone: doubled from 1 while the rows' blocks leave SMs without one, or
    a block would keep more than ``QUANT_THREADS * QUANT_KEEP`` values, up
    to ``QUANT_CLUSTER_MAX`` and as long as each block still takes 64
    bytes of the padded row or more."""
    chunks = padded_u(u) // CHUNK
    c = 1
    while (c < QUANT_CLUSTER_MAX and 2 * c <= chunks
           and (m * c < sm_count or u > c * QUANT_THREADS * QUANT_KEEP)):
        c *= 2
    return c


def wgmma_aim(sm_count) -> int:
    """The blocks a wgmma grid aims at: half the SMs. On an H100 more
    blocks than that (narrower tiles, more U slices) gained little at
    Llama-3-8B's prefill shapes and cost the split's int32 sums
    (``python -m mxnet_tpu_torch.int8_variants`` times the grids)."""
    return sm_count // 2


@functools.lru_cache(maxsize=1024)
def wgmma_plan(m, o, u, sm_count) -> SplitPlan:
    """The wgmma kernel's grid, from shapes and the SM count alone: tiles
    of 128 rows and 256 output channels where those alone reach
    :func:`wgmma_aim`, else 128 channels; where the tiles still fall short
    of the aim, U splits into the fewest slices of whole 128-byte chunks
    (none empty) that reach it, or one chunk a slice. ``grid`` is (O tiles,
    M tiles, slices) as :func:`split_plan`'s (the kernel runs the row tiles
    fastest); ``chunks_per_slice`` counts 128-byte chunks."""
    chunks = -(-u // WGMMA_CHUNK)
    rows = -(-m // WGMMA_ROWS)
    aim = wgmma_aim(sm_count)
    bn = 256 if rows * -(-o // 256) >= aim else 128
    grid = (-(-o // bn), rows)
    per = _chunks_per_slice(grid[0] * grid[1], chunks, aim)
    slices = -(-chunks // per)  # no empty slice
    return SplitPlan(WGMMA_ROWS, bn, slices, per, (*grid, slices),
                     slices * m * o * 4 if slices > 1 else 0)


def _sm_count(dev) -> int:
    n = _SM_COUNT.get(dev.index)
    if n is None:
        n = _SM_COUNT[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


# -- the CUDA kernels -----------------------------------------------------------


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load

        lib = load("int8_dense")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, pointers, ints in (
                ("dense", 8, 10), ("quantize_rows", 3, 5),
                ("dense_product", 7, 8), ("dense_wgmma", 8, 9),
                ("dense_wgmma_product", 7, 7), ("dense_decode", 8, 8),
                ("dense_decode_product", 7, 6)):
            fn = getattr(lib, f"mxtt_int8_{name}")
            fn.argtypes = [ptr] * pointers + [i32] * ints + [ptr]
            fn.restype = i32
        i32p = ctypes.POINTER(i32)
        lib.mxtt_int8_quantize_config.argtypes = [i32p] * 3
        lib.mxtt_int8_dense_decode_config.argtypes = [i32p] * 7
        lib.mxtt_int8_dense_decode_smem_bytes.argtypes = [i32, i32]
        for name in ("quantize_config", "dense_decode_config",
                     "dense_decode_smem_bytes"):
            getattr(lib, f"mxtt_int8_{name}").restype = i32
        for name in ("chunk", "rows"):
            fn = getattr(lib, f"mxtt_int8_dense_wgmma_{name}")
            fn.argtypes, fn.restype = [], i32
        lib.mxtt_int8_dense_wgmma_smem_bytes.argtypes = [i32]
        lib.mxtt_int8_dense_wgmma_smem_bytes.restype = i32
        for name in ("chunk", "block_cols", "smem_bytes"):
            fn = getattr(lib, f"mxtt_int8_dense_{name}")
            fn.argtypes = [] if name == "chunk" else [i32]
            fn.restype = i32
        lib.mxtt_int8_dense_attributes.argtypes = [i32] + [
            ctypes.POINTER(i32)] * 3
        lib.mxtt_int8_dense_attributes.restype = i32
        lib.mxtt_int8_error_string.argtypes = [i32]
        lib.mxtt_int8_error_string.restype = ctypes.c_char_p
        got = (lib.mxtt_int8_dense_chunk(),
               {bm: lib.mxtt_int8_dense_block_cols(bm) for bm in TILES})
        if got != (CHUNK, TILES):
            raise MXNetError(f"int8_dense.cu takes chunks of {got[0]} bytes "
                             f"and tiles {got[1]}, but the wrapper assumes "
                             f"{CHUNK} and {TILES}")
        got = (lib.mxtt_int8_dense_wgmma_chunk(),
               lib.mxtt_int8_dense_wgmma_rows(),
               [bn for bn in WGMMA_COLS
                if lib.mxtt_int8_dense_wgmma_smem_bytes(bn) > 0])
        want = (WGMMA_CHUNK, WGMMA_ROWS, list(WGMMA_COLS))
        if got != want:
            raise MXNetError(f"int8_dense.cu's wgmma kernel takes (stage "
                             f"bytes, rows, widths) {got}, but the wrapper "
                             f"assumes {want}")
        got = _ints(lib.mxtt_int8_dense_decode_config, 7)
        want = (DECODE_COLS, DECODE_CHUNK, DECODE_STAGE_ROWS, DECODE_STAGE,
                DECODE_STAGES, got[5], DECODE_ROWS)
        if got != want:
            raise MXNetError(f"int8_dense.cu's decode kernel takes (channels, "
                             f"chunk, stage rows, stage bytes, stages, "
                             f"threads, rows) {got}, but the wrapper assumes "
                             f"{want}")
        got = _ints(lib.mxtt_int8_quantize_config, 3)
        want = (QUANT_THREADS, QUANT_KEEP, QUANT_CLUSTER_MAX)
        if got != want:
            raise MXNetError(f"int8_dense.cu's row quantization takes "
                             f"(threads, values kept, blocks a row) {got}, "
                             f"but the wrapper assumes {want}")
        _LIB = lib
    return _LIB


def _ints(fn, n):
    """The ``n`` ints a C query ``fn(int*, ...)`` writes."""
    vals = [ctypes.c_int() for _ in range(n)]
    fn(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _lib()


def smem_bytes(block_rows) -> int:
    """Dynamic shared memory of a block of the ``mma.sync`` kernel of
    ``block_rows`` rows (builds the library)."""
    return _lib().mxtt_int8_dense_smem_bytes(block_rows)


def wgmma_smem_bytes(block_cols) -> int:
    """Dynamic shared memory of a block of the wgmma kernel of
    ``block_cols`` output channels (builds the library)."""
    return _lib().mxtt_int8_dense_wgmma_smem_bytes(block_cols)


def decode_smem_bytes(rows, chunks_per_slice) -> int:
    """Dynamic shared memory of a block of the decode kernel of ``rows``
    rows whose slices hold ``chunks_per_slice`` 128-byte chunks: the ring
    and the slice of xq (builds the library)."""
    return _lib().mxtt_int8_dense_decode_smem_bytes(rows, chunks_per_slice)


KERNELS = ("quantize_rows", "dense_16", "dense_64", "dense_128", "reduce",
           "dense_wgmma_128", "dense_wgmma_256", "dense_decode_8",
           "dense_decode_16", "dense_decode_24", "dense_decode_32")


def kernel_attributes() -> dict:
    """Each kernel's registers and local bytes a thread (a spill shows as
    local bytes) and the most threads a block, by name in ``KERNELS``
    (builds the library)."""
    lib = _lib()
    out = {}
    for which, name in enumerate(KERNELS):
        regs, local, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = lib.mxtt_int8_dense_attributes(
            which, ctypes.byref(regs), ctypes.byref(local),
            ctypes.byref(threads))
        if err:
            raise MXNetError(f"int8_dense attributes of {name}: "
                             f"{lib.mxtt_int8_error_string(err).decode()}")
        out[name] = {"registers": regs.value, "local_bytes": local.value,
                     "max_threads": threads.value}
    return out


def _use_kernel(x):
    """True to launch the kernel for ``x``; raises for a CPU tensor under
    ``force_path("cuda")``."""
    global _LAST_PATH
    if _FORCE_PATH == "cuda" or (_FORCE_PATH is None and x.is_cuda):
        if not x.is_cuda:
            raise MXNetError("force_path('cuda'): the int8_dense kernel "
                             f"needs CUDA tensors, got {x.device}")
        _LAST_PATH = "cuda"
        return True
    _LAST_PATH = "torch"
    return False


def _check(x, qweight, scale, bias):
    if x.dtype != torch.float32:
        raise MXNetError(f"int8_dense kernel: x must be float32, got {x.dtype}")
    if qweight.dtype != torch.int8 or qweight.dim() != 2:
        raise MXNetError(f"int8_dense kernel: qweight must be 2-D int8, got "
                         f"{qweight.dtype} {tuple(qweight.shape)}")
    o, u = qweight.shape
    if x.dim() < 1 or x.shape[-1] != u or 0 in (o, u):
        raise MXNetError(f"int8_dense: x {tuple(x.shape)} does not match "
                         f"qweight {tuple(qweight.shape)} as (..., U) @ (O, U).T")
    operands = [("x", x), ("qweight", qweight), ("scale", scale)]
    if bias is not None:
        operands.append(("bias", bias))
    for label, t in operands:
        if t.device != x.device:
            raise MXNetError(f"int8_dense: {label} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise MXNetError(f"int8_dense: {label} is not contiguous")
        if label in ("scale", "bias") and (t.dtype != torch.float32
                                           or tuple(t.shape) != (o,)):
            raise MXNetError(f"int8_dense kernel: {label} must be float32 "
                             f"({o},), got {t.dtype} {tuple(t.shape)}")
    if max(x.numel(), qweight.numel(), x.numel() // u * o) >= 2 ** 31:
        raise MXNetError("int8_dense kernel: an operand has 2**31 or more "
                         "elements")


_ENCODE_FAILED = 100000  # int8_dense.cu's kEncodeFailed (+ the CUresult)


def _raise_if(err, what, x, qweight, plan, route="mma_sync"):
    if err == 0:
        return
    lib = _lib()
    smem = (lib.mxtt_int8_dense_wgmma_smem_bytes(plan.block_cols)
            if route == "wgmma" else
            lib.mxtt_int8_dense_decode_smem_bytes(plan.block_rows,
                                                  plan.chunks_per_slice)
            if route == "decode" else
            lib.mxtt_int8_dense_smem_bytes(plan.block_rows))
    code = (f"CUresult {err - _ENCODE_FAILED}" if err >= _ENCODE_FAILED
            else f"cudaError {err}")
    raise MXNetError(
        f"int8_dense {what} launch of the {route} kernel failed: "
        f"{lib.mxtt_int8_error_string(err).decode()} ({code}; x "
        f"{tuple(x.shape)}, qweight {tuple(qweight.shape)} at "
        f"{qweight.data_ptr() % 16} bytes past 16, plan {plan}, shared "
        f"memory {smem} B)")


def _buffers(x2, o, plan):
    """The call's outputs and scratch: (xq, sx, out, ws)."""
    m, u = x2.shape
    dev = x2.device
    xq = torch.empty((m, padded_u(u)), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    out = torch.empty((m, o), dtype=torch.float32, device=dev)
    ws = (torch.empty(plan.workspace_bytes // 4, dtype=torch.int32,
                      device=dev) if plan.slices > 1 else None)
    return xq, sx, out, ws


def _vec(t, width):
    """1 when ``t`` starts 16-byte aligned and its rows are a multiple of
    ``width`` elements: the kernel may copy it by 16-byte vectors."""
    return int(t.data_ptr() % 16 == 0 and t.shape[-1] % width == 0)


def _ptr(t):
    return None if t is None else t.data_ptr()


# each route's grid: plan(m, o, u, sm_count)
PLANS = {"wgmma": wgmma_plan, "decode": decode_plan, "mma_sync": split_plan}


def _plan(route, m, o, u, dev):
    return PLANS[route](m, o, u, _sm_count(dev))


def _launch(x2, qweight, scale, bias):
    """All of a call on the card: quantize the rows, then the product on
    the kernel :func:`route_for` names. ``x2`` is (M, U) f32 with M >= 1;
    returns (M, O) f32."""
    global _LAUNCHES, _CAPTURED
    m, u = x2.shape
    o = qweight.shape[0]
    route = route_for(m, u, qweight.data_ptr())
    plan = _plan(route, m, o, u, x2.device)
    xq, sx, out, ws = _buffers(x2, o, plan)
    lib = _lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        common = (x2.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                  qweight.data_ptr(), scale.data_ptr(), _ptr(bias),
                  out.data_ptr(), _ptr(ws), m, o, u, xq.shape[1])
        split = (plan.chunks_per_slice, plan.slices,
                 quantize_cluster(m, u, _sm_count(x2.device)), _vec(x2, 4))
        if route == "decode":
            err = lib.mxtt_int8_dense_decode(*common, *split, stream)
        elif route == "wgmma":
            err = lib.mxtt_int8_dense_wgmma(*common, plan.block_cols, *split,
                                            stream)
        else:
            err = lib.mxtt_int8_dense(*common, plan.block_rows, *split,
                                      _vec(qweight, 16), stream)
    _raise_if(err, "", x2, qweight, plan, route)
    capturing = torch.cuda.is_current_stream_capturing()
    with _COUNT_LOCK:
        if capturing:
            _CAPTURED += 1
        else:
            _LAUNCHES += 1
            _ROUTE_LAUNCHES[route] += 1
            _ROW_LAUNCHES[route, m] = _ROW_LAUNCHES.get((route, m), 0) + 1
    return out


def quantize_rows(x2):
    """The row quantization kernel alone on ``x2`` (M, U) f32 CUDA:
    returns ``(xq, sx)``, xq (M, U rounded up to 64) int8 zero-padded and
    sx (M,) f32. For timing and tests; uncounted."""
    if not (x2.is_cuda and x2.dtype == torch.float32 and x2.dim() == 2
            and x2.is_contiguous() and x2.numel() > 0):
        raise MXNetError("int8_dense quantize_rows: x must be a non-empty "
                         "contiguous 2-D float32 CUDA tensor, got "
                         f"{x2.dtype} {tuple(x2.shape)} on {x2.device}")
    m, u = x2.shape
    xq = torch.empty((m, padded_u(u)), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        err = _lib().mxtt_int8_quantize_rows(
            x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, u, xq.shape[1],
            quantize_cluster(m, u, _sm_count(x2.device)), _vec(x2, 4),
            torch.cuda.current_stream(x2.device).cuda_stream)
    _raise_if(err, "quantize", x2, xq, split_plan(m, 1, u, 1))
    return xq, sx


def product(xq, sx, u, qweight, scale, bias=None, route=None):
    """The product kernel (and the split's sum) alone, from
    :func:`quantize_rows`' ``xq`` and ``sx`` at ``u`` columns: returns
    (M, O) f32. ``route`` names the kernel: ``"wgmma"`` or ``"decode"``
    (each raises where :func:`route_for` names another) or ``"mma_sync"``
    (which takes any call); None takes the one :func:`int8_dense` would.
    For timing the kernels on one call and for tests; uncounted."""
    m = xq.shape[0]
    o = qweight.shape[0]
    ptr = qweight.data_ptr()
    if route is None:
        route = route_for(m, u, ptr)
    if route not in ("mma_sync", route_for(m, u, ptr)):
        raise MXNetError(f"int8_dense product: route {route!r} does not "
                         f"take M={m}, U={u}, qweight at {ptr % 16} bytes "
                         "past 16")
    plan = _plan(route, m, o, u, xq.device)
    out = torch.empty((m, o), dtype=torch.float32, device=xq.device)
    ws = (torch.empty(plan.workspace_bytes // 4, dtype=torch.int32,
                      device=xq.device) if plan.slices > 1 else None)
    lib = _lib()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        common = (xq.data_ptr(), sx.data_ptr(), ptr, scale.data_ptr(),
                  _ptr(bias), out.data_ptr(), _ptr(ws), m, o, u, xq.shape[1])
        split = (plan.chunks_per_slice, plan.slices)
        if route == "decode":
            err = lib.mxtt_int8_dense_decode_product(*common, *split, stream)
        elif route == "wgmma":
            err = lib.mxtt_int8_dense_wgmma_product(
                *common, plan.block_cols, *split, stream)
        else:
            err = lib.mxtt_int8_dense_product(
                *common, plan.block_rows, *split, _vec(qweight, 16), stream)
    _raise_if(err, "product", xq, qweight, plan, route)
    return out


def int8_dense(x, qweight, scale, bias=None):
    """``x`` (..., U) f32 against ``qweight`` (O, U) int8 with per-output-
    channel ``scale`` (O,) f32 and optional ``bias`` (O,) f32, through
    int8 x int8 -> int32: the kernels on CUDA tensors, the plain version
    on CPU tensors. Returns (..., O) f32. See the module docstring."""
    if not _use_kernel(x):
        return int8_dense_torch(x, qweight, scale, bias)
    _check(x, qweight, scale, bias)
    o, u = qweight.shape
    x2 = x.reshape(-1, u)
    if x2.shape[0] == 0:  # an empty batch launches nothing
        return x.new_empty((*x.shape[:-1], o))
    return _launch(x2, qweight, scale, bias).reshape(*x.shape[:-1], o)
