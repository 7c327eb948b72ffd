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
``mxnet_tpu_torch/csrc/int8_dense.cu`` (the row quantization, the int8
``mma.sync`` product with the rescale fused and, where :func:`split_plan`
splits U across blocks, the in-order sum of the int32 partials); on CPU
tensors it takes :func:`int8_dense_torch`, the plain version. Nothing
falls back: a CUDA call the kernel does not take raises. The plain version
takes its product in float64, which is exact here (each partial sum stays
below 127**2 * U < 2**53), so the kernel equals it bit for bit.

``force_path("torch")`` takes the plain version for CUDA tensors too (the
yardstick the kernel is held against on the card); ``force_path("cuda")``
insists on the kernel and raises for CPU tensors. ``last_path()`` says
which version the last call took, and ``launch_count()`` counts the calls
the card ran (one per call, whatever kernels it took). A call made while a
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

_LAST_PATH = None  # "cuda" | "torch": the version the last call took
_FORCE_PATH = None
_LAUNCHES = 0     # calls the card ran: eager calls and graph replays
_CAPTURED = 0     # calls recorded into CUDA graphs while capturing
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
    global _LAUNCHES
    with _COUNT_LOCK:
        _LAUNCHES = 0


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
    x ``block_cols``, ``slices`` slices of ``chunks_per_slice`` 64-byte
    chunks of U (the last may be shorter), ``grid`` the (O tiles, M tiles,
    slices) of blocks, ``workspace_bytes`` the int32 partials (0 at one
    slice)."""
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
    tiles = grid[0] * grid[1]
    chunks = padded_u(u) // CHUNK
    aim = sm_count * BLOCKS_PER_SM[bm]
    per = chunks
    if tiles < aim:
        for s in range(2, chunks + 1):
            per = -(-chunks // s)
            if tiles * -(-chunks // per) >= aim:
                break
    slices = -(-chunks // per)  # no empty slice
    return SplitPlan(bm, bn, slices, per, (*grid, slices),
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
        _LIB = lib
    return _LIB


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _lib()


def smem_bytes(block_rows) -> int:
    """Dynamic shared memory of a block of ``block_rows`` rows (builds the
    library)."""
    return _lib().mxtt_int8_dense_smem_bytes(block_rows)


KERNELS = ("quantize_rows", "dense_16", "dense_64", "dense_128", "reduce")


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


def _raise_if(err, what, x, qweight, plan):
    if err == 0:
        return
    lib = _lib()
    raise MXNetError(
        f"int8_dense {what} launch failed: "
        f"{lib.mxtt_int8_error_string(err).decode()} (cudaError {err}; x "
        f"{tuple(x.shape)}, qweight {tuple(qweight.shape)}, plan {plan}, "
        f"shared memory {lib.mxtt_int8_dense_smem_bytes(plan.block_rows)} B)")


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


def _launch(x2, qweight, scale, bias):
    """All of a call on the card: quantize the rows, then the product.
    ``x2`` is (M, U) f32 with M >= 1; returns (M, O) f32."""
    global _LAUNCHES, _CAPTURED
    m, u = x2.shape
    o = qweight.shape[0]
    plan = split_plan(m, o, u, _sm_count(x2.device))
    xq, sx, out, ws = _buffers(x2, o, plan)
    lib = _lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.mxtt_int8_dense(
            x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), qweight.data_ptr(),
            scale.data_ptr(), _ptr(bias), out.data_ptr(), _ptr(ws), m, o, u,
            xq.shape[1], plan.block_rows, plan.chunks_per_slice, plan.slices,
            _vec(x2, 4), _vec(qweight, 16), stream)
    _raise_if(err, "", x2, qweight, plan)
    capturing = torch.cuda.is_current_stream_capturing()
    with _COUNT_LOCK:
        if capturing:
            _CAPTURED += 1
        else:
            _LAUNCHES += 1
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


def product(xq, sx, u, qweight, scale, bias=None):
    """The product kernel (and the split's sum) alone, from
    :func:`quantize_rows`' ``xq`` and ``sx`` at ``u`` columns: returns
    (M, O) f32. For timing and tests; uncounted."""
    m = xq.shape[0]
    o = qweight.shape[0]
    plan = split_plan(m, o, u, _sm_count(xq.device))
    out = torch.empty((m, o), dtype=torch.float32, device=xq.device)
    ws = (torch.empty(plan.workspace_bytes // 4, dtype=torch.int32,
                      device=xq.device) if plan.slices > 1 else None)
    with torch.cuda.device(xq.device):
        err = _lib().mxtt_int8_dense_product(
            xq.data_ptr(), sx.data_ptr(), qweight.data_ptr(),
            scale.data_ptr(), _ptr(bias), out.data_ptr(), _ptr(ws), m, o, u,
            xq.shape[1], plan.block_rows, plan.chunks_per_slice, plan.slices,
            _vec(qweight, 16), torch.cuda.current_stream(xq.device).cuda_stream)
    _raise_if(err, "product", xq, qweight, plan)
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
