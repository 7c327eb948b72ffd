"""Shape-stable f32 kernels of the strict ``baseline`` serving rung, on
Hopper.

The JAX package's ``baseline`` rung keeps one serving contract: the logits
of a T = 1 decode step equal, bit for bit, those of a full prefill of the
same prefix. It gets there with mul+reduce formulations whose summation
order does not follow the leading shape (``mxnet_tpu/ops/nn.py``:
``stable_dense`` at :1053, ``cached_attention``'s baseline branch at
:1018-1033, ``rms_norm`` at :497-508) and XLA compiler options. No
``pl.pallas_call`` answers them. On the card the library calls pick their
order by shape (cuBLAS its kernel and split-K by the rows of a product,
PyTorch's row reductions their block layout by the number of rows), so
this module holds three hand-written kernels
(``mxnet_tpu_torch/csrc/stable_ops.cu``) whose arithmetic for one output
element is a function of the reduced length alone:

* S1 :func:`stable_dense`: ``x (..., U) @ w (O, U).T (+ b)``;
* S2 :func:`stable_attention`: causal attention of q (B, H, T, D) at
  positions ``start_pos[b] + t`` over unexpanded (B, KV, S, D) rings;
* S3 :func:`stable_rms_norm`: RMSNorm along the last axis.

Beside each goes its plain PyTorch version (:func:`stable_dense_torch`,
:func:`stable_attention_torch`, :func:`stable_rms_norm_torch`): the JAX
formulas, whose reductions on the CPU depend on each output's own vector
only, so on the CPU they carry the contract. Routing depends only on where
the tensors are: CUDA tensors take the kernel or raise (float32 and
contiguous-able inputs only; nothing falls back); CPU tensors take the
plain version. ``force_path("torch")`` takes the plain version on the card
too (the yardstick the kernels are held against), ``force_path("cuda")``
insists on the kernels and raises for CPU tensors; ``last_path()`` says
which the last call took.

Counts: :data:`DENSE`, :data:`ATTENTION` and :data:`NORM` count their own
kernel's launches the card ran (eager calls and, through
``count_replays``, CUDA-graph replays; a launch made while a graph is
captured counts in ``captured_count()`` instead), so a
``serve.engine.GraphSession`` takes them as counters. :func:`launch_count`
reads all three; :func:`row_launches` counts eager launches by kernel and
rows (M for S1 and S3, T for S2).
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ...base import MXNetError

_MAX_D = 256
_MAX_WARPS = 8          # query heads an attention block carries (T = 1)
_ROWS_MAX = 32          # query rows an attention block carries (T > 1)
_SMEM_LIMIT = 232448    # dynamic shared memory a block may take (H100)
_PLAIN_BYTES = 1 << 28  # the plain versions' product tensors, at most

_LAST_PATH = None  # "cuda" | "torch": the version the last call took
_FORCE_PATH = None
_COUNT_LOCK = threading.Lock()
_ROW_LAUNCHES = {}  # eager launches by (kernel, rows)
_ROUTE_LAUNCHES = {}  # eager S2 launches by route ("heads", "rows")
_LIB = None
_SM_COUNT = {}  # device index -> multiprocessors


class _Counter:
    """One kernel's launch count: what the card ran (eager calls and graph
    replays) and what went into graphs being captured. Updates take the
    module's lock: every serving thread launches."""

    def __init__(self, name):
        self.name = name
        self._launches = 0
        self._captured = 0

    def launch_count(self) -> int:
        return self._launches

    def captured_count(self) -> int:
        """Launches recorded into CUDA graphs since import: a graph owner
        reads it around a capture to learn what one replay launches."""
        return self._captured

    def count_replays(self, n) -> None:
        """Add ``n`` launches run by a graph replay."""
        with _COUNT_LOCK:
            self._launches += int(n)

    def reset(self) -> None:
        with _COUNT_LOCK:
            self._launches = 0

    def _launched(self, rows, route=None):
        capturing = torch.cuda.is_current_stream_capturing()
        with _COUNT_LOCK:
            if capturing:
                self._captured += 1
            else:
                self._launches += 1
                key = (self.name, int(rows))
                _ROW_LAUNCHES[key] = _ROW_LAUNCHES.get(key, 0) + 1
                if route is not None:
                    _ROUTE_LAUNCHES[route] = _ROUTE_LAUNCHES.get(route, 0) + 1


DENSE = _Counter("dense")
ATTENTION = _Counter("attention")
NORM = _Counter("norm")
COUNTERS = (DENSE, ATTENTION, NORM)


def force_path(path) -> None:
    """Override routing: ``None`` (by device), ``"torch"`` (the plain
    versions, on any device) or ``"cuda"`` (the kernels; raises for CPU
    tensors)."""
    global _FORCE_PATH
    if path not in (None, "torch", "cuda"):
        raise ValueError(f"force_path: {path!r} not in (None,'torch','cuda')")
    _FORCE_PATH = path


def forced_path():
    """The override :func:`force_path` set; graph owners key their graphs
    by it, since a captured graph keeps the route it was captured on."""
    return _FORCE_PATH


def last_path():
    return _LAST_PATH


def launch_count() -> dict:
    """``{kernel: launches the card ran}`` for S1-S3 (eager calls and
    replayed graphs)."""
    return {c.name: c.launch_count() for c in COUNTERS}


def reset_launch_count() -> None:
    for c in COUNTERS:
        c.reset()
    with _COUNT_LOCK:
        _ROW_LAUNCHES.clear()
        _ROUTE_LAUNCHES.clear()


def row_launches() -> dict:
    """Eager launches since the last reset by ``(kernel, rows)``: M for
    ``dense`` and ``norm``, T for ``attention`` (graph replays are not
    split by rows)."""
    with _COUNT_LOCK:
        return dict(_ROW_LAUNCHES)


def route_launches() -> dict:
    """Eager S2 launches since the last reset by kernel: ``"heads"`` or
    ``"rows"`` (:func:`attention_route`)."""
    with _COUNT_LOCK:
        return dict(_ROUTE_LAUNCHES)


# ---------------------------------------------------------------------------
# Plain versions: the JAX formulas
# ---------------------------------------------------------------------------

def stable_dense_torch(x, weight, bias=None):
    """``x`` (..., U) against ``weight`` (O, U): ``sum(x[..., None, :] *
    w, -1) (+ bias)`` as ``mxnet_tpu.ops.nn.stable_dense`` writes it,
    chunked over O so that the (rows, chunk, U) product stays within
    ``_PLAIN_BYTES``. Every output is one sum over its own product
    vector."""
    u = x.shape[-1]
    o = weight.shape[0]
    x2 = x.reshape(-1, u)
    m = x2.shape[0]
    out = x2.new_empty((m, o))
    step = max(1, _PLAIN_BYTES // max(1, 4 * m * u))
    for o0 in range(0, o, step):
        out[:, o0:o0 + step] = torch.sum(
            x2[:, None, :] * weight[None, o0:o0 + step, :], dim=-1)
    if bias is not None:
        out = out + bias
    return out.reshape(*x.shape[:-1], o)


def stable_attention_torch(q, k, v, start_pos, scale=None):
    """The baseline ``cached_attention`` formula of the JAX package: q
    (B, H, T, D) at positions ``start_pos[b] + t`` over rings (B, KV, S,
    D), head h reading KV head ``h // (H // KV)``. Positions past
    ``start_pos[b] + t`` score ``-inf``; ``p = e / sum(e)``. Chunked over T
    so the (B, H, chunk, S, D) products stay within ``_PLAIN_BYTES``."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    heads = torch.arange(h, device=k.device) // (h // kv)
    kh = k.index_select(1, heads)                             # (B, H, S, D)
    vt = v.index_select(1, heads).transpose(-1, -2).contiguous()  # (B,H,D,S)
    pos = (start_pos.to(device=q.device, dtype=torch.long)[:, None]
           + torch.arange(t, device=q.device))                   # (B, T)
    valid = (torch.arange(s, device=q.device)[None, None, :]
             <= pos[:, :, None])                                 # (B, T, S)
    out = q.new_empty((b, h, t, d))
    step = max(1, _PLAIN_BYTES // max(1, 4 * b * h * s * d))
    for t0 in range(0, t, step):
        qc = q[:, :, t0:t0 + step]
        sc_ = torch.sum(qc[:, :, :, None, :] * kh[:, :, None], dim=-1) * sc
        sc_ = torch.where(valid[:, None, t0:t0 + step], sc_, float("-inf"))
        mx = torch.amax(sc_, dim=-1, keepdim=True)
        e = torch.exp(sc_ - mx)
        p = e / torch.sum(e, dim=-1, keepdim=True)
        out[:, :, t0:t0 + step] = torch.sum(
            p[:, :, :, None, :] * vt[:, :, None], dim=-1)
    return out


def stable_rms_norm_torch(x, gamma, eps=1e-6):
    """RMSNorm along the last axis in the JAX package's order: the mean of
    squares in f32, the reciprocal root, the product with x, then with
    gamma."""
    ms = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return x * (1.0 / torch.sqrt(ms + eps)).to(x.dtype) * gamma


# ---------------------------------------------------------------------------
# Plans (shapes only: pure Python, testable on the CPU)
# ---------------------------------------------------------------------------

# stable_ops.cu's S1 instantiations: index -> (rows, output channels) a
# lane (a warp's tile), and (warp rows, warp columns) a block. 0-5 (decode
# rows) have one warp row and 8 warps of channels; 6 is the first prefill
# tile (loads from global memory), kept to hold the others to and picked by
# no plan; 7 the prefill tile fed from a ring of shared-memory stages
DENSE_TILES = ((1, 1), (1, 2), (4, 1), (4, 2), (8, 1), (8, 2), (8, 8),
               (8, 8))
DENSE_WARPS = ((1, 8),) * 6 + ((2, 4), (4, 4))
GLOBAL_PREFILL_TILE = 6
PREFILL_TILE = 7
DECODE_ROWS = 32  # S1 takes the prefill tile above this many rows


def dense_plan(m, o, sm_count) -> int:
    """The S1 instantiation for M = ``m`` rows against O = ``o`` output
    channels: one output channel a warp, or two where that still gives
    every SM four blocks, at decode rows (M <= 32); the ring-fed prefill
    tile above. Every instantiation gives each output the same bits (see
    the source), so the plan is free to follow M."""
    if m > DECODE_ROWS:
        return PREFILL_TILE
    rows = 0 if m == 1 else 2 if m <= 4 else 4
    two = math.ceil(o / 16) >= 4 * sm_count
    return rows + int(two)


def dense_grid(tile, m, o):
    """The grid (row blocks, channel blocks) of S1's instantiation ``tile``
    at M = ``m``, O = ``o``."""
    (tm, to), (wm, wo) = DENSE_TILES[tile], DENSE_WARPS[tile]
    return math.ceil(m / (wm * tm)), math.ceil(o / (wo * to))


def dense_warp_tiles(tile, bx, by):
    """The (row, channel) origins of the warps of block (``bx``, ``by``) of
    instantiation ``tile``: warp w at rows ``(bx * WM + w // WO) * TM`` and
    channels ``(by * WO + w % WO) * TO`` (the kernels' map; each warp
    stores the outputs of its tile that lie inside M x O)."""
    (tm, to), (wm, wo) = DENSE_TILES[tile], DENSE_WARPS[tile]
    return [((bx * wm + w // wo) * tm, (by * wo + w % wo) * to)
            for w in range(wm * wo)]


def attention_warps(h, kv) -> int:
    """Query heads (warps) an S2 block carries at T = 1: one KV head's G =
    H / KV heads, at most 8 (larger groups take several blocks)."""
    return min(h // kv, _MAX_WARPS)


def attention_smem_bytes(warps, s, d) -> int:
    """Dynamic shared memory of one S2 block at T = 1: two K tiles (32 x
    (D + 1)), two V tiles (32 x D), the warps' query rows and their S
    scores."""
    return 4 * (2 * 32 * (d + 1) + 2 * 32 * d + warps * d + warps * s)


def _ceil4(v):
    return (v + 3) // 4 * 4


def attention_rows_smem_bytes(rows, s, d) -> int:
    """Dynamic shared memory of one S2 rows block (T > 1) of ``rows`` query
    rows: two K tiles (32 x (ceil4(D) + 4)), two V tiles (32 x ceil4(D)),
    the query rows (ceil4(D) each) and their scores (ceil4(S) each)."""
    dv = _ceil4(d)
    return 4 * (2 * 32 * (dv + 4) + 2 * 32 * dv + rows * dv
                + rows * _ceil4(s))


def attention_rows_plan(h, kv, t, s, d):
    """``(tq, gb)`` for S2 at T = ``t`` > 1: a block carries ``tq``
    consecutive query times of ``gb`` query heads of one KV head (tq * gb
    <= 32 rows), so a staged K/V tile serves tq * gb rows. The most rows
    whose shared memory fits a block, heads first; ``None`` when not even
    one row fits. Shapes only."""
    g = h // kv
    gb = min(g, _ROWS_MAX)
    tq = max(1, min(t, _ROWS_MAX // gb))
    while tq > 1 and attention_rows_smem_bytes(tq * gb, s, d) > _SMEM_LIMIT:
        tq //= 2
    while gb > 1 and attention_rows_smem_bytes(gb, s, d) > _SMEM_LIMIT:
        gb //= 2
    if attention_rows_smem_bytes(tq * gb, s, d) > _SMEM_LIMIT:
        return None
    return tq, gb


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

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

        lib = load("stable_ops")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pi32 = ctypes.POINTER(ctypes.c_int)
        lib.mxtt_stable_dense.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.mxtt_stable_dense.restype = i32
        lib.mxtt_stable_dense_tile.argtypes = [i32, pi32, pi32, pi32]
        lib.mxtt_stable_dense_tile.restype = i32
        lib.mxtt_stable_attention.argtypes = ([ptr] * 5 + [i32] * 7
                                              + [f32, i32, ptr])
        lib.mxtt_stable_attention.restype = i32
        lib.mxtt_stable_attention_smem_bytes.argtypes = [i32] * 3
        lib.mxtt_stable_attention_smem_bytes.restype = ctypes.c_longlong
        lib.mxtt_stable_attention_rows.argtypes = ([ptr] * 5 + [i32] * 8
                                                   + [f32, i32, ptr])
        lib.mxtt_stable_attention_rows.restype = i32
        lib.mxtt_stable_attention_rows_smem_bytes.argtypes = [i32] * 3
        lib.mxtt_stable_attention_rows_smem_bytes.restype = ctypes.c_longlong
        lib.mxtt_stable_rms_norm.argtypes = [ptr] * 3 + [i32, i32, f32, i32,
                                                         ptr]
        lib.mxtt_stable_rms_norm.restype = i32
        lib.mxtt_stable_kernel_attributes.argtypes = [i32, pi32, pi32, pi32]
        lib.mxtt_stable_kernel_attributes.restype = i32
        lib.mxtt_error_string.argtypes = [i32]
        lib.mxtt_error_string.restype = ctypes.c_char_p
        for i, ((tm, to), (wm, wo)) in enumerate(zip(DENSE_TILES,
                                                     DENSE_WARPS)):
            got = [ctypes.c_int() for _ in range(3)]
            lib.mxtt_stable_dense_tile(i, *got)
            want = (wm * tm, wo * to, 32 * wm * wo)
            if tuple(g.value for g in got) != want:
                raise MXNetError(f"stable_ops.cu's dense tile {i} covers "
                                 f"{[g.value for g in got]} (rows, columns, "
                                 f"threads), the wrapper assumes {want}")
        for w, s, d in ((4, 1024, 128), (2, 64, 30)):
            if lib.mxtt_stable_attention_smem_bytes(w, s, d) != \
                    attention_smem_bytes(w, s, d):
                raise MXNetError("stable_ops.cu's attention shared memory "
                                 "differs from the wrapper's")
            if lib.mxtt_stable_attention_rows_smem_bytes(8 * w, s, d) != \
                    attention_rows_smem_bytes(8 * w, s, d):
                raise MXNetError("stable_ops.cu's rows attention shared "
                                 "memory differs from the wrapper's")
        _LIB = lib
    return _LIB


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _lib()


def kernel_attributes() -> dict:
    """Registers, spilled (local) bytes a thread and the block limit of
    each kernel, by name: ``dense_t{i}`` for S1's instantiations (the
    prefill tile's kernel for aligned rows, ``dense_t7_unaligned`` its
    kernel for the others), ``attention_nd{n}`` for S2's heads kernel (n =
    ceil(D / 32)), ``attention_rows_nd{n}`` for its rows kernel (n =
    ceil(D / 128)), ``norm``."""
    lib = _lib()
    names = ([f"dense_t{i}" for i in range(len(DENSE_TILES))]
             + [f"attention_nd{n}" for n in (1, 2, 4, 8)]
             + [f"attention_rows_nd{n}" for n in (1, 2)]
             + [f"dense_t{PREFILL_TILE}_unaligned", "norm"])
    out = {}
    for i, name in enumerate(names):
        regs, local, threads = (ctypes.c_int() for _ in range(3))
        err = lib.mxtt_stable_kernel_attributes(i, regs, local, threads)
        if err:
            raise MXNetError(f"stable_ops kernel_attributes({name}): "
                             f"{lib.mxtt_error_string(err).decode()}")
        out[name] = {"registers": regs.value, "local_bytes": local.value,
                     "max_threads": threads.value}
    return out


def _use_kernel(x, what):
    """True to launch the kernel for ``x``; raises for a CPU tensor under
    ``force_path("cuda")``."""
    global _LAST_PATH
    if _FORCE_PATH == "cuda" or (_FORCE_PATH is None and x.is_cuda):
        if not x.is_cuda:
            raise MXNetError(f"force_path('cuda'): the {what} kernel needs "
                             f"CUDA tensors, got {x.device}")
        _LAST_PATH = "cuda"
        return True
    _LAST_PATH = "torch"
    return False


def _check(what, ref, **tensors):
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != ref.device:
            raise MXNetError(f"{what}: {name} on {t.device}, expected "
                             f"{ref.device}")
        if t.dtype != torch.float32:
            raise MXNetError(f"{what} kernel: {name} must be float32, got "
                             f"{t.dtype}")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _raise_if(err, what, shapes):
    if err != 0:
        raise MXNetError(f"{what} launch failed: "
                         f"{_lib().mxtt_error_string(err).decode()} "
                         f"(cudaError {err}; {shapes})")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def dense_launch(x2, weight, bias=None, tile=None):
    """S1 on ``x2`` (M, U) f32 CUDA against ``weight`` (O, U): the
    instantiation :func:`dense_plan` picks, or ``tile`` (an index into
    :data:`DENSE_TILES`; every one gives the same bits). Returns (M, O).
    Uncounted: the tests and ``chip_smoke.py`` call it to hold one
    instantiation against another."""
    m, u = x2.shape
    o = weight.shape[0]
    if tile is None:
        tile = dense_plan(m, o, _sm_count(x2.device))
    out = torch.empty((m, o), dtype=torch.float32, device=x2.device)
    vec = int(u % 4 == 0 and _aligned(x2, weight))
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.mxtt_stable_dense(
            x2.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, o,
            u, vec, int(tile), _stream(x2.device))
    _raise_if(err, "stable_dense kernel",
              f"x {tuple(x2.shape)}, weight {tuple(weight.shape)}, tile "
              f"{tile}, vec {vec}")
    return out


def stable_dense(x, weight, bias=None):
    """S1: ``x`` (..., U) f32 against ``weight`` (O, U) f32 (and ``bias``
    (O,)), every output one fixed-order sum over U whatever the rows: the
    kernel on CUDA tensors, :func:`stable_dense_torch` on the CPU. Returns
    (..., O)."""
    if not _use_kernel(x, "stable_dense"):
        return stable_dense_torch(x, weight, bias)
    _check("stable_dense", x, x=x, weight=weight, bias=bias)
    o, u = weight.shape
    if x.shape[-1] != u or (bias is not None and tuple(bias.shape) != (o,)):
        raise MXNetError(f"stable_dense: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    x2 = x.reshape(-1, u).contiguous()
    if x2.shape[0] == 0:
        return x.new_empty((*x.shape[:-1], o))
    out = dense_launch(x2, weight.contiguous(),
                       None if bias is None else bias.contiguous())
    DENSE._launched(x2.shape[0])
    return out.reshape(*x.shape[:-1], o)


def attention_route(b, h, kv, t, s, d, sm_count) -> str:
    """S2's kernel for q (b, h, t, d) over rings of ``s`` positions:
    ``"heads"`` (a block a query time, a warp a query head) at T = 1 and
    wherever the rows kernel's grid would leave SMs idle; ``"rows"`` (a
    block of several query times and heads, :func:`attention_rows_plan`)
    where its grid has a block for every SM. Both give every row the same
    bits, so the route is free to follow the shapes."""
    if t == 1:
        return "heads"
    plan = attention_rows_plan(h, kv, t, s, d)
    if plan is None:  # no rows block fits: neither does a heads block
        return "rows"
    tq, gb = plan
    blocks = math.ceil(t / tq) * b * kv * math.ceil(h // kv / gb)
    return "rows" if blocks >= sm_count else "heads"


def attention_launch(q, k, v, sp, scale, route):
    """S2's kernel ``route`` (``"heads"`` or ``"rows"``, at any T: every
    route gives every row the same bits) on contiguous f32 CUDA ``q`` (B,
    H, T, D) and rings ``k``/``v`` (B, KV, S, D), ``sp`` (B,) int32 on the
    card. Returns (B, H, T, D). Uncounted: the tests and ``chip_smoke.py``
    call it to hold one route against the other."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _lib()
    if route == "heads":
        warps = attention_warps(h, kv)
        smem = attention_smem_bytes(warps, s, d)
        plan = f"warps {warps}"
        vec = int(d % 4 == 0 and _aligned(v))
    elif route == "rows":
        tg = attention_rows_plan(h, kv, t, s, d)
        smem = (attention_rows_smem_bytes(1, s, d) if tg is None
                else attention_rows_smem_bytes(tg[0] * tg[1], s, d))
        plan = f"(tq, gb) {tg}"
        vec = int(d % 4 == 0 and _aligned(k, v))
    else:
        raise ValueError(f"attention_launch: route {route!r} not in "
                         "('heads', 'rows')")
    if smem > _SMEM_LIMIT:
        raise MXNetError(f"stable_attention kernel: a ring of {s} positions "
                         f"at D = {d} needs {smem} bytes of shared memory a "
                         f"block, more than {_SMEM_LIMIT}")
    with torch.cuda.device(q.device):
        if route == "heads":
            err = lib.mxtt_stable_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), sp.data_ptr(),
                out.data_ptr(), b, h, t, kv, s, d, warps, scale, vec,
                _stream(q.device))
        else:
            err = lib.mxtt_stable_attention_rows(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), sp.data_ptr(),
                out.data_ptr(), b, h, t, kv, s, d, tg[0], tg[1], scale, vec,
                _stream(q.device))
    _raise_if(err, "stable_attention kernel",
              f"q {tuple(q.shape)}, k {tuple(k.shape)}, route {route}, "
              f"{plan}, vec {vec}, shared memory {smem} B")
    return out


def stable_attention(q, k, v, start_pos, scale=None):
    """S2: causal attention of ``q`` (B, H, T, D) at positions
    ``start_pos[b] + t`` over unexpanded ``k``/``v`` rings (B, KV, S, D),
    f32; ``start_pos`` (B,) int. The kernel on CUDA tensors,
    :func:`stable_attention_torch` on the CPU. Returns (B, H, T, D)."""
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not _use_kernel(q, "stable_attention"):
        return stable_attention_torch(q, k, v, start_pos, sc)
    _check("stable_attention", q, q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("stable_attention: q, k, v must be 4-D")
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (b, kv, s, d) or tuple(v.shape) != (b, kv, s, d)
            or kv == 0 or h % kv or d > _MAX_D or s == 0):
        raise MXNetError(f"stable_attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (H a "
                         f"multiple of KV, D <= {_MAX_D})")
    if start_pos.device != q.device or tuple(start_pos.shape) != (b,):
        raise MXNetError(f"stable_attention: start_pos must be ({b},) on "
                         f"{q.device}, got {tuple(start_pos.shape)} on "
                         f"{start_pos.device}")
    route = attention_route(b, h, kv, t, s, d, _sm_count(q.device))
    out = attention_launch(q.contiguous(), k.contiguous(), v.contiguous(),
                           start_pos.to(torch.int32).contiguous(), sc, route)
    ATTENTION._launched(t, route)
    return out


def stable_rms_norm(x, gamma, eps=1e-6):
    """S3: RMSNorm of ``x`` (..., N) f32 with ``gamma`` (N,) along the last
    axis, each row one fixed-order sum whatever the rows: the kernel on
    CUDA tensors, :func:`stable_rms_norm_torch` on the CPU."""
    if not _use_kernel(x, "stable_rms_norm"):
        return stable_rms_norm_torch(x, gamma, eps)
    _check("stable_rms_norm", x, x=x, gamma=gamma)
    n = x.shape[-1]
    if tuple(gamma.shape) != (n,):
        raise MXNetError(f"stable_rms_norm: gamma {tuple(gamma.shape)} for "
                         f"rows of {n}")
    x2 = x.reshape(-1, n).contiguous()
    g = gamma.contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    vec = int(n % 4 == 0 and _aligned(x2, g, out))
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.mxtt_stable_rms_norm(x2.data_ptr(), g.data_ptr(),
                                       out.data_ptr(), x2.shape[0], n,
                                       float(eps), vec, _stream(x.device))
    _raise_if(err, "stable_rms_norm kernel",
              f"x {tuple(x.shape)}, vec {vec}")
    NORM._launched(x2.shape[0])
    return out.reshape(x.shape)
