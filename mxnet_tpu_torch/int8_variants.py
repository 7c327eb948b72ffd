"""Build text-edited variants of the int8 product's wgmma kernel side by
side and time them, and its grid's alternatives, on one card.

    python -m mxnet_tpu_torch.int8_variants

A variant is ``mxnet_tpu_torch/csrc/int8_dense.cu`` with some text replaced
(every replaced text must occur in the source), built with ``nvcc`` into
``build/int8_variants/``, one process each, all started together. At each
Llama-3-8B projection at prefill rows (M = 256 and 1024; O, U = 4096 x
4096, 1024 x 4096, 14336 x 4096, 4096 x 14336) every variant's wgmma
product (K2w, with K3 where U is split) runs the grid ``wgmma_plan`` gives
and, for the source, every grid of 128 or 256 output channels and 1, 2, 4
or 8 U slices as well. Each run must equal the plain version bit for bit
(``matches_plain``); each is timed as the median of 25 launches by CUDA
events with the L2 cache flushed before each, over two rounds, the second
in reverse order, beside ``torch._int_mm`` on the same quantized operands
and the ``mma.sync`` kernel's product. The source's plan and ``_int_mm``
are also timed after a flush that reads the 64 MiB buffer in place of
writing it (``clean_l2``): the written flush leaves its lines dirty in L2,
and the first kernel after it pays for writing them back. The first line
is the card's name
and power limit; a line per shape gives the times; a last line per M the
sums over one forward's 224 products.

The variants: ``source``; ``hand_back_late`` (each consumer warpgroup
keeps one stage's products in flight and hands back the stage before,
where the source waits for a stage's products and hands it back at once);
``columns_fast`` (the column tiles fastest in the grid, where the source
runs the row tiles fastest); ``more_stages`` (4 stages at 256 channels
and 6 at 128, where the source has 3 and 5); and diagnostics that each
drop one part of the work: ``no_products`` (no ``wgmma``), ``no_copies``
(no TMA: the producer arrives on each stage without filling it),
``no_stores`` (the epilogue computes but does not write ``out``).
"""
from __future__ import annotations

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
}
# (O, U, products in one forward): Llama-3-8B's projections per layer x 32
SHAPES = [(4096, 4096, 64), (1024, 4096, 64), (14336, 4096, 64),
          (4096, 14336, 32)]
ROWS = (256, 1024)
GRIDS = [(bn, slices) for bn in (128, 256) for slices in (1, 2, 4, 8)]


class _ReadFlush:
    """Stands for the flush buffer in ``_time_ms``: its ``zero_`` reads the
    buffer (a sum) instead of writing it, so L2 is cold but clean."""

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
        lib.mxtt_int8_dense_wgmma_product.argtypes = [ptr] * 7 + [i32] * 7 + [
            ptr]
        lib.mxtt_int8_dense_wgmma_product.restype = i32
        libs[name] = lib
    return libs


def main():
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
    source = (build.CSRC / "int8_dense.cu").read_text()
    t0 = time.perf_counter()
    libs = _build([(n, variant_source(source, subs))
                   for n, subs in VARIANTS.items()],
                  build.BUILD_DIR.parent / "int8_variants")
    print(f"[variant] built={len(libs)} seconds="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    flush = torch.empty(64 << 18, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
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
                        _time_ms(torch, fn, _ReadFlush(flush)))
            best = {k: min(v) for k, v in times.items()}
            for k, v in best.items():
                sums.setdefault((m, k), 0.0)
                sums[(m, k)] += v * per_forward
            print(f"[variant] M={m} O={o} U={u} plan={plan.block_cols}x"
                  f"{plan.slices} matches_plain={ok} " + " ".join(
                      f"{n}:{g}=" + "/".join(f"{t:.6f}" for t in ts)
                      for (n, g), ts in times.items()), flush=True)
            del x, w, xq, ws, fns
            torch.cuda.empty_cache()
    for m in ROWS:
        print(f"[variant] M={m} forward_sums_ms " + " ".join(
            f"{n}:{g}={v:.6f}" for (mm, (n, g)), v in sums.items()
            if mm == m and g in ("plan", "_int_mm", "mma_sync", "plan_clean_l2",
                                 "_int_mm_clean_l2")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
