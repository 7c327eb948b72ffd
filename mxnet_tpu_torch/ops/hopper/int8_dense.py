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
``mxnet_tpu_torch/csrc/int8_dense.cu``: the row quantization, one of two
product kernels with the rescale fused and, where the plan splits U across
blocks, the in-order sum of the int32 partials. :func:`takes_wgmma` routes
the product: prefill rows (M > 32) on a weight whose rows are a multiple of
16 bytes and which starts 16-byte aligned run the ``wgmma`` + TMA kernel
(grid: :func:`wgmma_plan`); every other CUDA call (decode and verify rows,
a ragged or misaligned weight) runs the ``mma.sync`` kernel (grid:
:func:`split_plan`). On CPU tensors it takes :func:`int8_dense_torch`, the
plain version. Nothing falls back: a CUDA call the kernels do not take
raises. The plain version takes its product in float64, which is exact
here (each partial sum stays below 127**2 * U < 2**53), so either kernel
equals it bit for bit.

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
ROUTES = ("wgmma", "mma_sync")

_LAST_PATH = None  # "cuda" | "torch": the version the last call took
_FORCE_PATH = None
_LAUNCHES = 0     # calls the card ran: eager calls and graph replays
_CAPTURED = 0     # calls recorded into CUDA graphs while capturing
_ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)  # eager calls by product kernel
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
    """Zero :func:`launch_count` and :func:`route_launches`."""
    global _LAUNCHES
    with _COUNT_LOCK:
        _LAUNCHES = 0
        for r in ROUTES:
            _ROUTE_LAUNCHES[r] = 0


def route_launches() -> dict:
    """Eager calls since import (or the last reset) by the product kernel
    they ran: ``"wgmma"`` or ``"mma_sync"``. Calls captured into CUDA
    graphs and their replays count in :func:`captured_count` and
    :func:`launch_count` only."""
    with _COUNT_LOCK:
        return dict(_ROUTE_LAUNCHES)


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
    (64 bytes on the ``mma.sync`` kernel, 128 on wgmma; the last slice may
    be shorter), ``grid`` the (O tiles, M tiles, slices) of blocks,
    ``workspace_bytes`` the int32 partials (0 at one slice)."""
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


def takes_wgmma(m, u, qweight_ptr) -> bool:
    """The routing predicate of a CUDA call of ``m`` rows against a weight
    of ``u`` int8 columns at address ``qweight_ptr``: True for the wgmma
    kernel, which takes prefill rows (more than 32; :func:`block_rows_for`
    gives them 64 or 128 on the ``mma.sync`` kernel) on a weight TMA can
    read (rows a multiple of 16 bytes, the start 16-byte aligned); False
    for the ``mma.sync`` kernel, which takes the rest."""
    return m > 32 and u % 16 == 0 and qweight_ptr % 16 == 0


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
        lib.mxtt_int8_dense.argtypes = [ptr] * 8 + [i32] * 9 + [ptr]
        lib.mxtt_int8_dense.restype = i32
        lib.mxtt_int8_quantize_rows.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        lib.mxtt_int8_quantize_rows.restype = i32
        lib.mxtt_int8_dense_product.argtypes = [ptr] * 7 + [i32] * 8 + [ptr]
        lib.mxtt_int8_dense_product.restype = i32
        lib.mxtt_int8_dense_wgmma.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
        lib.mxtt_int8_dense_wgmma.restype = i32
        lib.mxtt_int8_dense_wgmma_product.argtypes = [ptr] * 7 + [i32] * 7 + [
            ptr]
        lib.mxtt_int8_dense_wgmma_product.restype = i32
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
        _LIB = lib
    return _LIB


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


KERNELS = ("quantize_rows", "dense_16", "dense_64", "dense_128", "reduce",
           "dense_wgmma_128", "dense_wgmma_256")


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


def _plan(route, m, o, u, dev):
    return (wgmma_plan if route == "wgmma" else split_plan)(
        m, o, u, _sm_count(dev))


def _launch(x2, qweight, scale, bias):
    """All of a call on the card: quantize the rows, then the product on
    the kernel :func:`takes_wgmma` picks. ``x2`` is (M, U) f32 with M >= 1;
    returns (M, O) f32."""
    global _LAUNCHES, _CAPTURED
    m, u = x2.shape
    o = qweight.shape[0]
    route = "wgmma" if takes_wgmma(m, u, qweight.data_ptr()) else "mma_sync"
    plan = _plan(route, m, o, u, x2.device)
    xq, sx, out, ws = _buffers(x2, o, plan)
    lib = _lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        common = (x2.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                  qweight.data_ptr(), scale.data_ptr(), _ptr(bias),
                  out.data_ptr(), _ptr(ws), m, o, u, xq.shape[1])
        if route == "wgmma":
            err = lib.mxtt_int8_dense_wgmma(
                *common, plan.block_cols, plan.chunks_per_slice, plan.slices,
                _vec(x2, 4), stream)
        else:
            err = lib.mxtt_int8_dense(
                *common, plan.block_rows, plan.chunks_per_slice, plan.slices,
                _vec(x2, 4), _vec(qweight, 16), stream)
    _raise_if(err, "", x2, qweight, plan, route)
    capturing = torch.cuda.is_current_stream_capturing()
    with _COUNT_LOCK:
        if capturing:
            _CAPTURED += 1
        else:
            _LAUNCHES += 1
            _ROUTE_LAUNCHES[route] += 1
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
            _vec(x2, 4), torch.cuda.current_stream(x2.device).cuda_stream)
    _raise_if(err, "quantize", x2, xq, split_plan(m, 1, u, 1))
    return xq, sx


def product(xq, sx, u, qweight, scale, bias=None, route=None):
    """The product kernel (and the split's sum) alone, from
    :func:`quantize_rows`' ``xq`` and ``sx`` at ``u`` columns: returns
    (M, O) f32. ``route`` names the kernel, ``"wgmma"`` (which raises where
    :func:`takes_wgmma` is False) or ``"mma_sync"`` (which takes any call);
    None takes the one :func:`int8_dense` would. For timing the two on one
    call and for tests; uncounted."""
    m = xq.shape[0]
    o = qweight.shape[0]
    takes = takes_wgmma(m, u, qweight.data_ptr())
    if route is None:
        route = "wgmma" if takes else "mma_sync"
    if route not in ROUTES or (route == "wgmma" and not takes):
        raise MXNetError(f"int8_dense product: route {route!r} does not "
                         f"take M={m}, U={u}, qweight at "
                         f"{qweight.data_ptr() % 16} bytes past 16")
    plan = _plan(route, m, o, u, xq.device)
    out = torch.empty((m, o), dtype=torch.float32, device=xq.device)
    ws = (torch.empty(plan.workspace_bytes // 4, dtype=torch.int32,
                      device=xq.device) if plan.slices > 1 else None)
    lib = _lib()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        common = (xq.data_ptr(), sx.data_ptr(), qweight.data_ptr(),
                  scale.data_ptr(), _ptr(bias), out.data_ptr(), _ptr(ws), m,
                  o, u, xq.shape[1])
        if route == "wgmma":
            err = lib.mxtt_int8_dense_wgmma_product(
                *common, plan.block_cols, plan.chunks_per_slice, plan.slices,
                stream)
        else:
            err = lib.mxtt_int8_dense_product(
                *common, plan.block_rows, plan.chunks_per_slice, plan.slices,
                _vec(qweight, 16), stream)
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
