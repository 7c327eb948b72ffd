"""Build text-edited variants of the int8 product's kernels side by side
and time them, and their grids' alternatives, on one card.

    python -m mxnet_tpu_torch.int8_variants [--rows decode|prefill|all]

A variant is ``mxnet_tpu_torch/csrc/int8_dense.cu`` with some text replaced
(every replaced text must occur in the source), built with ``nvcc`` into
``build/int8_variants/``, one process each, all started together. Every
run must equal the plain version bit for bit (``matches_plain``); each is
timed as the median of 25 launches by CUDA events with the L2 cache
flushed before each, over two rounds, the second in reverse order. The
first line is the card's name and power limit; a line per shape gives the
times; a last line per M the sums over one forward's products.

Prefill rows (``--rows prefill``): at each Llama-3-8B projection at
M = 256 and 1024 (O, U = 4096 x 4096, 1024 x 4096, 14336 x 4096,
4096 x 14336) every variant's wgmma product (K2w, with K3 where U is
split) runs the grid ``wgmma_plan`` gives and, for the source, every grid
of 128 or 256 output channels and 1, 2, 4 or 8 U slices as well, beside
``torch._int_mm`` on the same quantized operands and the ``mma.sync``
kernel's product. The source's plan and ``_int_mm`` are also timed after a
flush that reads the 64 MiB buffer in place of writing it
(``clean_l2``): the written flush leaves its lines dirty in L2, and the
first kernel after it pays for writing them back. Variants: ``source``;
``hand_back_late`` (each consumer warpgroup keeps one stage's products in
flight and hands back the stage before, where the source waits for a
stage's products and hands it back at once); ``columns_fast`` (the column
tiles fastest in the grid, where the source runs the row tiles fastest);
``more_stages`` (4 stages at 256 channels and 6 at 128, where the source
has 3 and 5); and diagnostics that each drop one part of the work:
``no_products`` (no ``wgmma``), ``no_copies`` (no TMA: the producer
arrives on each stage without filling it), ``no_stores`` (the epilogue
computes but does not write ``out``).

Decode rows (``--rows decode``): at M = 1, 4 and 20 on the same four
projections and the head (128256 x 4096), every variant's decode product
(K2d, with K3 where U is split) runs the grid ``decode_plan`` gives and,
for the source, the grids of 1, 2, 4, 8 and 16 U slices whose xq fits a
block as well (``s1`` ...), beside the ``mma.sync`` tile kernel's
product (the yardstick), K1 alone, and the whole call (K1, K2d, K3)
eagerly (``call``) and as a replayed CUDA graph of one call (``graph``), of
the source and of ``decode_no_pdl`` (the decode route's kernels launched
without programmatic dependent launch: does the chain gain, and does the
capture keep the programmatic edge?). Variants: ``decode_stages_2``,
``decode_stages_3`` and ``decode_stages_6`` (stages in the ring, the
source 4: bytes in flight), ``decode_rows_64_stage_256`` and
``decode_rows_32_stage_512`` (a stage of 64 channels x 256 bytes or 32 x
512, where the source's is 16 x 1,024: the same bytes in 4 or 2 times as
many bulk copies), ``decode_stage_2048_stages_2`` (2 stages of 16 x 2,048),
``decode_no_pdl``, ``decode_no_evict_first`` (the weight's copies without
the source's hint that L2 evict their lines first), and diagnostics: ``decode_no_products``
(no ``mma.sync``), ``decode_no_copies`` (no bulk copies: the producer
arrives on each stage without filling it). The source's plan,
the ``mma.sync`` product, K1 and the whole call are also timed after the
clean flush (``_clean_l2``), beside a library read of the weight's bytes
(``torch:read_weight``, an int64 sum: the stream's yardstick). Before the
decode rows, K1 alone at M = 1, 4, 20, 256 and 1024 and U = 4096 and
14336 (sums over a forward's 193 and 32 calls), on 1, 2, 4 and 8 blocks a
row and on the wrapper's choice (``plan``), after the clean flush.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import time

from .flash_variants import _nvidia_smi, _time_ms, variant_source

VARIANTS = {
    "source": [],
    "hand_back_late": [
        ("""      wgmma_wait_all();
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[st]);
    }
""", """      asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
      if (j > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(j + T::kStages - 1) % T::kStages]);
    }
    wgmma_wait_all();
""")],
    "columns_fast": [
        ("const int m0 = blockIdx.x * kWRows, o0 = blockIdx.y * BN",
         "const int o0 = blockIdx.x * BN, m0 = blockIdx.y * kWRows"),
        ("const dim3 grid(rows, (O + BN - 1) / BN, slices);",
         "const dim3 grid((O + BN - 1) / BN, rows, slices);")],
    "more_stages": [("kStages = BN == 256 ? 3 : 5",
                     "kStages = BN == 256 ? 4 : 6")],
    # diagnostics: each drops one part of the work (and fails the check)
    "no_products": [(
        "for (int kk = 0; kk < kWChunk / 32; ++kk) wgmma<BN>(acc, da + 2 * kk, "
        "db + 2 * kk);", "acc[0] ^= static_cast<int>(da ^ db);")],
    "no_copies": [("""        mbar_expect_tx(&full[st], T::kStage);
        const int k0 = (kbeg + j) * kWChunk;
        tma_load(a, &ta, &full[st], k0, m0);
        tma_load(a + T::kA, &tb, &full[st], k0, o0);""",
                   """        mbar_arrive(&full[st]);
        (void)a;""")],
    "no_stores": [("""          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(r0, r1);""",
                   """          if (r0 == 1.25f) {
            *reinterpret_cast<float2*>(dst) = make_float2(r0, r1);""")],
    # the decode kernel (K2d)
    "decode_stages_2": [("constexpr int kDStages = 4;",
                         "constexpr int kDStages = 2;")],
    "decode_stages_3": [("constexpr int kDStages = 4;",
                         "constexpr int kDStages = 3;")],
    "decode_stages_6": [("constexpr int kDStages = 4;",
                         "constexpr int kDStages = 6;")],
    "decode_rows_64_stage_256": [
        ("constexpr int kDStageRows = 16;", "constexpr int kDStageRows = 64;"),
        ("constexpr int kDStage = 1024;", "constexpr int kDStage = 256;")],
    "decode_rows_32_stage_512": [
        ("constexpr int kDStageRows = 16;", "constexpr int kDStageRows = 32;"),
        ("constexpr int kDStage = 1024;", "constexpr int kDStage = 512;")],
    "decode_stage_2048_stages_2": [
        ("constexpr int kDStage = 1024;", "constexpr int kDStage = 2048;"),
        ("constexpr int kDStages = 4;", "constexpr int kDStages = 2;")],
    "decode_no_pdl": [(
        """  attr->val.programmaticStreamSerializationAllowed = 1;
  return 1;""", """  attr->val.programmaticStreamSerializationAllowed = 1;
  return 0;""")],
    "decode_no_evict_first": [(
        """  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");""",
        """  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");""")],
    "decode_no_products": [("""          mma_s8(acc[q][i], a0.x, a1.x, a0.y, a1.y, b0.x, b0.y);
          mma_s8(acc[q][i], a0.z, a1.z, a0.w, a1.w, b0.z, b0.w);
          mma_s8(acc[q][i], a0b.x, a1b.x, a0b.y, a1b.y, b1.x, b1.y);
          mma_s8(acc[q][i], a0b.z, a1b.z, a0b.w, a1b.w, b1.z, b1.w);""",
                            """          acc[q][i][0] ^= a0.x ^ a1.y ^ a0b.z ^ a1b.w ^ b0.x ^ b1.w;""")],
    "decode_no_copies": [("""      if (lane == 0) mbar_expect_tx(&full[st], static_cast<unsigned>(rows * bytes));
      __syncwarp();
      for (int r = lane; r < rows; r += 32)
        bulk_load(dst + r * kDPitch, w + static_cast<size_t>(c0 + r) * U + k0, bytes, &full[st]);""",
                          """      if (lane == 0) mbar_arrive(&full[st]);
      (void)dst;
      (void)bytes;
      (void)rows;""")],
}
PREFILL_VARIANTS = ("source", "hand_back_late", "columns_fast", "more_stages",
                    "no_products", "no_copies", "no_stores")
DECODE_VARIANTS = ("source", "decode_stages_2", "decode_stages_3",
                   "decode_stages_6", "decode_rows_64_stage_256",
                   "decode_rows_32_stage_512", "decode_stage_2048_stages_2",
                   "decode_no_pdl", "decode_no_evict_first",
                   "decode_no_products", "decode_no_copies")
# the decode diagnostics, which drop work and so differ from the plain version
DECODE_DIAGNOSTICS = ("decode_no_products", "decode_no_copies")
# the whole decode call is timed on these builds: with and without the chain
DECODE_CALLS = ("source", "decode_no_pdl")
# (O, U, products in one forward): Llama-3-8B's projections per layer x 32
SHAPES = [(4096, 4096, 64), (1024, 4096, 64), (14336, 4096, 64),
          (4096, 14336, 32)]
ROWS = (256, 1024)
GRIDS = [(bn, slices) for bn in (128, 256) for slices in (1, 2, 4, 8)]
# decode rows: the projections and the head, once a forward
DECODE_SHAPES = SHAPES + [(128256, 4096, 1)]
DECODE_ROWS = (1, 4, 20)
DECODE_SLICES = (1, 2, 4, 8, 16)
# the row quantization: (U, calls in one forward) and rows; every
# projection quantizes its own input (q, k and v each), the head at decode
# only
K1_SHAPES = [(4096, 6 * 32 + 1), (14336, 32)]
K1_ROWS = (1, 4, 20, 256, 1024)
K1_CLUSTERS = (1, 2, 4, 8)


class ReadFlush:
    """Stands for the flush buffer in a timer that calls ``flush.zero_()``
    before each launch: its ``zero_`` reads the buffer (a sum) instead of
    writing it, so L2 is cold but holds no dirty line (the written flush
    leaves its lines dirty, and the first kernel after it pays for writing
    them back: a weight stream's reads then share the memory with the
    flush's writes, which no decode step makes)."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.sum()


def _build(names_sources, out_dir):
    """Compile each (name, source text) with ``nvcc``, all at once; returns
    {name: ctypes.CDLL}, printing the compiler's output of a failed one."""
    import subprocess

    from .ops.hopper import _build as build

    nvcc = build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in names_sources:
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln
                  and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
        if proc.returncode:
            print(f"[variant] name={name} build_failed\n{log[-4000:]}",
                  flush=True)
            continue
        print(f"[variant] name={name} spills={spills or None}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn, pointers, ints in (("dense_wgmma_product", 7, 7),
                                   ("dense_decode_product", 7, 6),
                                   ("dense_decode", 8, 8),
                                   ("quantize_rows", 3, 5)):
            f = getattr(lib, f"mxtt_int8_{fn}")
            f.argtypes = [ptr] * pointers + [i32] * ints + [ptr]
            f.restype = i32
        libs[name] = lib
    return libs


def _prefill(torch, i8, libs, dev, sms, flush, stream):
    sums = {}
    for m in ROWS:
        for o, u, per_forward in SHAPES:
            gen = torch.Generator(device=dev).manual_seed(m + o)
            x = torch.randn(m, u, device=dev, generator=gen)
            w = torch.randint(-127, 128, (o, u), device=dev,
                              dtype=torch.int8, generator=gen)
            s = torch.rand(o, device=dev, generator=gen) * 0.01 + 1e-3
            xq, sx = i8.quantize_rows(x)
            ref = i8.int8_dense_torch(x, w, s)
            plan = i8.wgmma_plan(m, o, u, sms)
            chunks = -(-u // i8.WGMMA_CHUNK)
            runs = {(name, "plan"): (plan.block_cols, plan.chunks_per_slice,
                                     plan.slices) for name in libs}
            for bn, slices in GRIDS:
                cps = -(-chunks // slices)
                if -(-chunks // cps) == slices and "source" in libs:
                    runs[("source", f"{bn}x{slices}")] = (bn, cps, slices)
            ws = torch.empty(8 * m * o, dtype=torch.int32, device=dev)

            def call(lib, bn, cps, slices, out):
                return lib.mxtt_int8_dense_wgmma_product(
                    xq.data_ptr(), sx.data_ptr(), w.data_ptr(), s.data_ptr(),
                    None, out.data_ptr(), ws.data_ptr(), m, o, u, xq.shape[1],
                    bn, cps, slices, stream)

            fns, ok = {}, True
            for key, (bn, cps, slices) in runs.items():
                out = torch.full((m, o), float("nan"), device=dev)
                err = call(libs[key[0]], bn, cps, slices, out)
                torch.cuda.synchronize()
                good = err == 0 and torch.equal(out, ref)
                ok = ok and good
                if not good:
                    print(f"[variant] name={key[0]} grid={key[1]} M={m} O={o} "
                          f"U={u} matches_plain=False err={err}", flush=True)
                fns[key] = (lambda lib=libs[key[0]], a=(bn, cps, slices),
                            out=out: call(lib, *a, out))
            xu = xq[:, :u]
            fns[("torch", "_int_mm")] = lambda: torch._int_mm(xu, w.t())
            clean = {("source", "plan_clean_l2"): fns[("source", "plan")],
                     ("torch", "_int_mm_clean_l2"): fns[("torch", "_int_mm")]}
            fns[("source", "mma_sync")] = lambda: i8.product(
                xq, sx, u, w, s, route="mma_sync")
            times = {}
            for order in (list(fns), list(fns)[::-1]):
                for key in order:
                    times.setdefault(key, []).append(
                        _time_ms(torch, fns[key], flush))
                for key, fn in clean.items():
                    times.setdefault(key, []).append(
                        _time_ms(torch, fn, ReadFlush(flush)))
            _add(sums, m, per_forward, times)
            print(f"[variant] M={m} O={o} U={u} plan={plan.block_cols}x"
                  f"{plan.slices} matches_plain={ok} " + _line(times),
                  flush=True)
            del x, w, xq, ws, fns
            torch.cuda.empty_cache()
    for m in ROWS:
        _sum_line(sums, m, ("plan", "_int_mm", "mma_sync", "plan_clean_l2",
                            "_int_mm_clean_l2"),
                  every_variant=PREFILL_VARIANTS)


def _graph_of(torch, fn):
    """``fn``'s launches captured in a CUDA graph (warmed on a side stream
    first); returns the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def _decode(torch, i8, libs, dev, sms, flush):
    sums = {}
    for o, u, per_forward in DECODE_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(o + u)
        w = torch.randint(-127, 128, (o, u), device=dev, dtype=torch.int8,
                          generator=gen)
        s = torch.rand(o, device=dev, generator=gen) * 0.01 + 1e-3
        chunks = -(-u // i8.DECODE_CHUNK)
        for m in DECODE_ROWS:
            x = torch.randn(m, u, device=dev, generator=gen)
            xq, sx = i8.quantize_rows(x)
            ref = i8.int8_dense_torch(x, w, s)
            plan = i8.decode_plan(m, o, u, sms)
            cluster = i8.quantize_cluster(m, u, sms)
            runs = {(name, "plan"): (plan.chunks_per_slice, plan.slices)
                    for name in libs}
            for slices in DECODE_SLICES:
                cps = -(-chunks // slices)
                if (-(-chunks // cps) == slices and "source" in libs
                        and slices != plan.slices
                        and i8.decode_smem_bytes(plan.block_rows, cps)
                        <= 226 * 1024):
                    runs[("source", f"s{slices}")] = (cps, slices)
            ws = torch.empty(16 * m * o, dtype=torch.int32, device=dev)
            xqc = torch.empty_like(xq)
            sxc = torch.empty_like(sx)

            def product(lib, cps, slices, out):
                return lib.mxtt_int8_dense_decode_product(
                    xq.data_ptr(), sx.data_ptr(), w.data_ptr(), s.data_ptr(),
                    None, out.data_ptr(), ws.data_ptr(), m, o, u, xq.shape[1],
                    cps, slices, torch.cuda.current_stream().cuda_stream)

            def whole(lib, out):
                return lib.mxtt_int8_dense_decode(
                    x.data_ptr(), xqc.data_ptr(), sxc.data_ptr(), w.data_ptr(),
                    s.data_ptr(), None, out.data_ptr(), ws.data_ptr(), m, o,
                    u, xq.shape[1], plan.chunks_per_slice, plan.slices,
                    cluster, 1, torch.cuda.current_stream().cuda_stream)

            fns, ok = {}, True
            for key, (cps, slices) in runs.items():
                out = torch.full((m, o), float("nan"), device=dev)
                err = product(libs[key[0]], cps, slices, out)
                torch.cuda.synchronize()
                good = err == 0 and torch.equal(out, ref)
                ok = ok and (good or key[0] in DECODE_DIAGNOSTICS)
                if not good:
                    print(f"[variant] name={key[0]} grid={key[1]} M={m} O={o} "
                          f"U={u} matches_plain=False err={err}", flush=True)
                fns[key] = (lambda lib=libs[key[0]], a=(cps, slices),
                            out=out: product(lib, *a, out))
            for name in DECODE_CALLS:
                if name not in libs:
                    continue
                out = torch.full((m, o), float("nan"), device=dev)
                fn = (lambda lib=libs[name], out=out: whole(lib, out))
                err = fn()
                torch.cuda.synchronize()
                good = err == 0 and torch.equal(out, ref)
                replay = _graph_of(torch, fn)
                out.fill_(float("nan"))
                replay()
                torch.cuda.synchronize()
                good = good and torch.equal(out, ref)
                ok = ok and good
                if not good:
                    print(f"[variant] name={name} call M={m} O={o} U={u} "
                          f"matches_plain=False err={err}", flush=True)
                fns[(name, "call")] = fn
                fns[(name, "graph")] = replay
            fns[("source", "k1")] = lambda: i8.quantize_rows(x)
            fns[("source", "mma_sync")] = lambda: i8.product(
                xq, sx, u, w, s, route="mma_sync")
            # a library read of the weight's bytes: the stream's yardstick
            w64 = w.view(torch.int64)
            fns[("torch", "read_weight")] = lambda: w64.sum()
            clean = {(n, g + "_clean_l2"): fns[(n, g)] for n, g in (
                ("source", "plan"), ("source", "mma_sync"), ("source", "k1"),
                ("source", "call"), ("source", "graph"),
                ("torch", "read_weight")) if (n, g) in fns}
            times = {}
            for order in (list(fns), list(fns)[::-1]):
                for key in order:
                    times.setdefault(key, []).append(
                        _time_ms(torch, fns[key], flush))
                for key, fn in clean.items():
                    times.setdefault(key, []).append(
                        _time_ms(torch, fn, ReadFlush(flush)))
            _add(sums, m, per_forward, times)
            print(f"[variant] M={m} O={o} U={u} plan=s{plan.slices}x"
                  f"{plan.chunks_per_slice} blocks={plan.blocks} "
                  f"quantize_blocks_a_row={cluster} matches_plain={ok} "
                  + _line(times), flush=True)
            del x, xq, xqc, ws, fns
        del w, s
        torch.cuda.empty_cache()
    for m in DECODE_ROWS:
        _sum_line(sums, m, ("plan", "mma_sync", "k1", "call", "graph",
                            "read_weight", "plan_clean_l2",
                            "mma_sync_clean_l2", "k1_clean_l2",
                            "call_clean_l2", "graph_clean_l2",
                            "read_weight_clean_l2"),
                  every_variant=DECODE_VARIANTS, whole=DECODE_CALLS)


def _k1(torch, i8, lib, dev, sms, flush):
    """The source's K1 on 1, 2, 4 and 8 blocks a row (and the wrapper's
    choice, ``plan``) against the plain quantization, timed."""
    sums = {}
    for u, per_forward in K1_SHAPES:
        for m in K1_ROWS:
            gen = torch.Generator(device=dev).manual_seed(m * u)
            x = torch.randn(m, u, device=dev, generator=gen)
            pq, psx = i8.quantize_rows_torch(x)
            up = i8.padded_u(u)
            xq = torch.empty((m, up), dtype=torch.int8, device=dev)
            sx = torch.empty((m,), device=dev)
            plan = i8.quantize_cluster(m, u, sms)
            fns, ok = {}, True
            for c in K1_CLUSTERS:
                if 2 * c > up // i8.CHUNK and c > 1:
                    continue

                def fn(c=c):
                    return lib.mxtt_int8_quantize_rows(
                        x.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, u, up,
                        c, 1, torch.cuda.current_stream().cuda_stream)
                xq.fill_(1)
                err = fn()
                torch.cuda.synchronize()
                good = (err == 0 and torch.equal(xq[:, :u], pq)
                        and torch.equal(sx, psx[:, 0]) and not xq[:, u:].any())
                ok = ok and good
                if not good:
                    print(f"[variant] k1 blocks_a_row={c} M={m} U={u} "
                          f"matches_plain=False err={err}", flush=True)
                fns[("source", f"c{c}")] = fn
                if c == plan:
                    fns[("source", "plan")] = fn
            times = {}
            for order in (list(fns), list(fns)[::-1]):
                for key in order:
                    times.setdefault(key, []).append(
                        _time_ms(torch, fns[key], ReadFlush(flush)))
            _add(sums, m, per_forward, times)
            print(f"[variant] k1 M={m} U={u} plan=c{plan} matches_plain={ok} "
                  + _line(times), flush=True)
            del x, xq
    for m in K1_ROWS:
        print(f"[variant] k1 M={m} forward_sums_ms " + " ".join(
            f"{n}:{g}={v:.6f}" for (mm, (n, g)), v in sums.items()
            if mm == m), flush=True)


def _add(sums, m, per_forward, times):
    for k, v in times.items():
        sums.setdefault((m, k), 0.0)
        sums[(m, k)] += min(v) * per_forward


def _line(times):
    return " ".join(f"{n}:{g}=" + "/".join(f"{t:.6f}" for t in ts)
                    for (n, g), ts in times.items())


def _sum_line(sums, m, grids, every_variant, whole=()):
    """The sums over a forward at M: the source's ``grids``, every
    variant's plan and the whole call of the variants in ``whole``."""
    print(f"[variant] M={m} forward_sums_ms " + " ".join(
        f"{n}:{g}={v:.6f}" for (mm, (n, g)), v in sums.items()
        if mm == m and (g in grids and n in ("source", "torch")
                        or g == "plan" and n in every_variant
                        or g in ("call", "graph") and n in whole)),
        flush=True)


def main(argv=()):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", choices=("decode", "prefill", "all"),
                    default="all")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("int8_variants: CUDA is not available", file=sys.stderr)
        return 2
    from .ops.hopper import _build as build
    from .ops.hopper import int8_dense as i8

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    names = {"decode": DECODE_VARIANTS, "prefill": PREFILL_VARIANTS,
             "all": tuple(VARIANTS)}[args.rows]
    source = (build.CSRC / "int8_dense.cu").read_text()
    t0 = time.perf_counter()
    libs = _build([(n, variant_source(source, VARIANTS[n])) for n in names],
                  build.BUILD_DIR.parent / "int8_variants")
    print(f"[variant] built={len(libs)} seconds="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    flush = torch.empty(64 << 18, device=dev)
    if args.rows in ("decode", "all"):
        if "source" in libs:
            _k1(torch, i8, libs["source"], dev, sms, flush)
        _decode(torch, i8, {n: libs[n] for n in DECODE_VARIANTS if n in libs},
                dev, sms, flush)
    if args.rows in ("prefill", "all"):
        _prefill(torch, i8,
                 {n: libs[n] for n in PREFILL_VARIANTS if n in libs}, dev,
                 sms, flush, torch.cuda.current_stream().cuda_stream)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
