"""Build text-edited variants of the strict rung's S1 prefill tile side by
side and time them, and S2's and S3's kernels, on one card.

    python -m mxnet_tpu_torch.stable_variants

A variant is ``mxnet_tpu_torch/csrc/stable_ops.cu`` with some text replaced
(every replaced text must occur in the source), built with ``nvcc`` into
``build/stable_variants/``, one process each, all started together. Each
launch is timed as the median of 25 by CUDA events with the L2 cache
flushed before each. The first line is the card's name and power limit.

S1 at prefill rows: the plan's tile (``PREFILL_TILE``, the ring-fed 8 x 8
tile a lane) of every variant at Llama-3-8B's four layer products at
M = 1024, beside the first prefill tile (``GLOBAL_PREFILL_TILE``, loads from
global memory) and f32 ``F.linear``; a line per shape and one with the sums
over a prefill forward's 224 products. Every variant that keeps the work
must equal the first prefill tile bit for bit (``matches``). Variants:
``source``; ``lag_1`` (a thread refills the stage of the chunk just before
the one it read: the warps move nearly together, as under a barrier);
``stages_4`` (4 stages, refills 2 chunks behind, where the source has 6 and
3); ``lane_tile_8x16`` (an 8 x 16 tile a lane, 4 x 2 warps: fewer
shared-memory reads a FMA, half the warps); and diagnostics that each drop
one part of the work: ``copies_only`` (the ring fills, no FMA),
``no_copies`` (the FMAs on whatever the stages hold).

S2 at T = 256 (B = 4, H = 32, KV = 8, a 1024-position ring, D = 128, from
position 0, the strict rung's prefill): the rows kernel at the plans (tq,
gb) of 8, 16 and 32 rows a block, and the heads kernel, each bit for bit the
heads kernel's output. S2 at T = 1 (the same heads and ring; the decode
step at the middle of a 32-token generate, positions 33-266, and over a
full ring, positions 1000-1023): the decode kernel on clusters of 4 and 8
blocks (the sizes whose blocks fit at this ring), each bit for bit the
heads kernel, beside it.

S2's decode diagnostics on clusters of 8 (each drops one part of the work,
so its output differs): ``decode_no_pass3`` (no output chains),
``decode_no_gather`` (no e_j read from the other blocks).

S3 at 4 rows (a decode step) and 1024 rows (a prefill) of 4096: the staged
kernel with its rows by one bulk copy each (``source``) and by every
thread's 16-byte ``cp.async`` (``norm_cp_async16``), at 1024 rows also at
1, 2, 4 and 8 rows a block, beside the warp-a-row kernel, each bit for bit
the warp-a-row kernel's output.
"""
from __future__ import annotations

import ctypes
import sys
import time

from .flash_variants import _nvidia_smi, _time_ms, variant_source

_RING = "launch_dense_ring<8, 8, 4, 4, 6, 3>(x, w, bias, out, M, O, U, vec, st)"
VARIANTS = {
    "source": [],
    "lag_1": [(_RING, _RING.replace("6, 3>", "6, 1>"))],
    "stages_4": [(_RING, _RING.replace("6, 3>", "4, 2>"))],
    "lane_tile_8x16": [(_RING, _RING.replace("<8, 8, 4, 4,", "<8, 16, 4, 2,"))],
    # diagnostics: each drops one part of the work
    "copies_only": [(
        "    const int live = U - (c * kChunk + 4 * lane);  // the lane's "
        "positions inside U", "    const int live = -1;")],
    "no_copies": [(
        "          cp_async16(dst + r * kChunk + q, (is_x ? x : w) + "
        "static_cast<size_t>(row) * U + u0 + q);", "          (void)row;")],
}
DIAGNOSTICS = ("copies_only", "no_copies")
# S3's staged kernel with its rows by 16-byte cp.async, not bulk copies
NORM_VARIANTS = {"norm_cp_async16": [(
    "constexpr bool kNormBulkCopy = true;",
    "constexpr bool kNormBulkCopy = false;")]}
# S2's decode kernel, diagnostics that each drop one part of its work
DECODE_DIAGNOSTICS = {
    "decode_no_pass3": [(
        "      if (o < nh * nd) {\n        const int i = o / nd, dd",
        "      if (o < 0) {\n        const int i = o / nd, dd")],
    "decode_no_gather": [(
        "    for (int f0 = threadIdx.x; f0 < items; f0 += 4 * blockDim.x) {",
        "    for (int f0 = threadIdx.x; f0 < 0; f0 += 4 * blockDim.x) {")],
}
_NOT_S1 = {**NORM_VARIANTS, **DECODE_DIAGNOSTICS}
# (O, U, products in one forward): Llama-3-8B's layer products x 32
SHAPES = [(4096, 4096, 64), (1024, 4096, 64), (14336, 4096, 64),
          (4096, 14336, 32)]
ROWS = 1024
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores


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
        if proc.returncode:
            print(f"[variant] name={name} build_failed\n{log[-4000:]}",
                  flush=True)
            continue
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mxtt_stable_dense.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.mxtt_stable_attention.argtypes = ([ptr] * 5 + [i32] * 7
                                              + [f32, i32, ptr])
        lib.mxtt_stable_attention_rows.argtypes = ([ptr] * 5 + [i32] * 8
                                                   + [f32, i32, ptr])
        lib.mxtt_stable_attention_decode.argtypes = ([ptr] * 5 + [i32] * 8
                                                     + [f32, i32, ptr])
        lib.mxtt_stable_rms_norm.argtypes = [ptr] * 3 + [i32, i32, f32, i32,
                                                         ptr]
        lib.mxtt_stable_rms_norm_staged.argtypes = ([ptr] * 3 + [i32] * 3
                                                    + [f32, i32, ptr])
        libs[name] = lib
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("stable_variants: CUDA is not available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from .ops.hopper import _build as build
    from .ops.hopper import stable_ops as st

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    source = (build.CSRC / "stable_ops.cu").read_text()
    t0 = time.perf_counter()
    libs = _build([(n, variant_source(source, subs))
                   for n, subs in {**VARIANTS, **_NOT_S1}.items()],
                  build.BUILD_DIR.parent / "stable_variants")
    print(f"[variant] built={len(libs)} seconds="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    flush = torch.empty(64 << 18, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(23)
    ok = True

    def dense(lib, tile, x, w, out):
        m, u = x.shape
        err = lib.mxtt_stable_dense(x.data_ptr(), w.data_ptr(), None,
                                    out.data_ptr(), m, w.shape[0], u, 1,
                                    tile, stream)
        if err:
            raise RuntimeError(f"stable_dense launch failed: {err}")

    sums = {}
    for o, u, n in SHAPES:
        x = torch.randn(ROWS, u, device=dev, generator=gen)
        w = (torch.rand(o, u, device=dev, generator=gen) - 0.5) * 0.14
        ref = torch.empty(ROWS, o, device=dev)
        out = torch.empty_like(ref)
        src = libs["source"]
        dense(src, st.GLOBAL_PREFILL_TILE, x, w, ref)
        fma_ms = 2 * ROWS * o * u / F32_FLOP_PER_S * 1e3
        arms = [("first_tile", src, st.GLOBAL_PREFILL_TILE)] + [
            (name, lib, st.PREFILL_TILE) for name, lib in libs.items()
            if name not in _NOT_S1]
        fields = {}
        for name, lib, tile in arms:
            out.zero_()
            dense(lib, tile, x, w, out)
            torch.cuda.synchronize()
            match = bool(torch.equal(out, ref))
            if name not in DIAGNOSTICS:
                ok &= match
            ms = _time_ms(torch, lambda: dense(lib, tile, x, w, out), flush)
            sums[name] = sums.get(name, 0.0) + n * ms
            fields[name] = f"{ms:.6f}" + ("" if match or name in DIAGNOSTICS
                                          else "(differs)")
        lin = _time_ms(torch, lambda: F.linear(x, w), flush)
        sums["f32_linear"] = sums.get("f32_linear", 0.0) + n * lin
        sums["f32_fma_bound"] = sums.get("f32_fma_bound", 0.0) + n * fma_ms
        print(f"[s1] m={ROWS} o={o} u={u} f32_linear_ms={lin:.6f} "
              f"f32_fma_bound_ms={fma_ms:.6f} "
              + " ".join(f"{k}_ms={v}" for k, v in fields.items()),
              flush=True)
        del x, w, ref, out
    print("[s1] forward_products=224 "
          + " ".join(f"{k}_ms={v:.6f}" for k, v in sums.items()), flush=True)

    b, h, kv, t, s, d = 4, 32, 8, 256, 1024, 128
    q = torch.randn(b, h, t, d, device=dev, generator=gen)
    k = torch.randn(b, kv, s, d, device=dev, generator=gen)
    v = torch.randn(b, kv, s, d, device=dev, generator=gen)
    sp = torch.zeros(b, dtype=torch.int32, device=dev)
    ref, out = torch.empty_like(q), torch.empty_like(q)
    src, sc = libs["source"], 1.0 / d ** 0.5
    heads = lambda o_: src.mxtt_stable_attention(  # noqa: E731
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sp.data_ptr(),
        o_.data_ptr(), b, h, t, kv, s, d, st.attention_warps(h, kv), sc, 1,
        stream)
    heads(ref)
    fields = {"heads": f"{_time_ms(torch, lambda: heads(out), flush):.6f}"}
    for tq, gb in ((2, 4), (4, 4), (8, 4)):
        rows = lambda o_: src.mxtt_stable_attention_rows(  # noqa: E731
            q.data_ptr(), k.data_ptr(), v.data_ptr(), sp.data_ptr(),
            o_.data_ptr(), b, h, t, kv, s, d, tq, gb, sc, 1, stream)
        out.zero_()
        rows(out)
        torch.cuda.synchronize()
        match = bool(torch.equal(out, ref))
        ok &= match
        fields[f"rows_tq{tq}_gb{gb}"] = (
            f"{_time_ms(torch, lambda: rows(out), flush):.6f}"
            + ("" if match else "(differs)"))
    print(f"[s2] b={b} h={h} kv={kv} t={t} s={s} d={d} "
          + " ".join(f"{k_}_ms={v_}" for k_, v_ in fields.items()),
          flush=True)
    ok &= _decode_arms(torch, st, libs, flush, stream, gen)
    ok &= _norm_arms(torch, st, libs, flush, stream, gen)
    print(f"[variant] matches={ok}", flush=True)
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    return 0 if ok else 1


def _decode_arms(torch, st, libs, flush, stream, gen):
    """S2 at T = 1 on Llama-3-8B's heads over a 1024-position ring: the
    heads kernel and the decode kernel on clusters of 4 and 8 blocks (and
    the diagnostics on 8), at phase 3c's positions and over a full ring;
    returns whether every decode arm that keeps the work equals the heads
    kernel bit for bit."""
    src = libs["source"]
    dev = torch.device("cuda", 0)
    b, h, kv, s, d = 4, 32, 8, 1024, 128
    q = torch.randn(b, h, 1, d, device=dev, generator=gen)
    k = torch.randn(b, kv, s, d, device=dev, generator=gen)
    v = torch.randn(b, kv, s, d, device=dev, generator=gen)
    ref, out = torch.empty_like(q), torch.empty_like(q)
    sc, gb, ok = 1.0 / d ** 0.5, min(h // kv, 8), True
    for label, pos in (("mid_generate", [33, 80, 146, 266]),
                       ("full_ring", [1000, 1007, 1016, 1023])):
        sp = torch.tensor(pos, dtype=torch.int32, device=dev)
        heads = lambda o_: src.mxtt_stable_attention(  # noqa: E731
            q.data_ptr(), k.data_ptr(), v.data_ptr(), sp.data_ptr(),
            o_.data_ptr(), b, h, 1, kv, s, d, st.attention_warps(h, kv), sc,
            1, stream)
        heads(ref)
        fields = {"heads": f"{_time_ms(torch, lambda: heads(out), flush):.6f}"}
        arms = [(f"decode_cluster{c}", src, c) for c in (4, 8)] + [
            (name, libs[name], 8) for name in DECODE_DIAGNOSTICS
            if name in libs]
        for name, lib, c in arms:
            dec = lambda o_: lib.mxtt_stable_attention_decode(  # noqa: E731
                q.data_ptr(), k.data_ptr(), v.data_ptr(), sp.data_ptr(),
                o_.data_ptr(), b, h, 1, kv, s, d, c, gb, sc, 1, stream)
            out.zero_()
            if dec(out):
                raise RuntimeError(f"decode launch failed ({name})")
            torch.cuda.synchronize()
            match = bool(torch.equal(out, ref))
            if name not in DECODE_DIAGNOSTICS:
                ok &= match
            fields[name] = (f"{_time_ms(torch, lambda: dec(out), flush):.6f}"
                            + ("" if match or name in DECODE_DIAGNOSTICS
                               else "(differs)"))
        print(f"[s2] b={b} h={h} kv={kv} t=1 s={s} d={d} positions={label} "
              + " ".join(f"{k_}_ms={v_}" for k_, v_ in fields.items()),
              flush=True)
    return ok


def _norm_arms(torch, st, libs, flush, stream, gen):
    """S3 at 4 and 1024 rows of 4096: the warp-a-row kernel and the staged
    kernel of each copy style; returns whether every staged arm equals the
    warp-a-row kernel bit for bit."""
    dev = torch.device("cuda", 0)
    n, ok = 4096, True
    gamma = torch.rand(n, device=dev, generator=gen) + 0.5
    for m in (4, 1024):
        x = torch.randn(m, n, device=dev, generator=gen)
        ref, out = torch.empty_like(x), torch.empty_like(x)
        warp = lambda lib, o_: lib.mxtt_stable_rms_norm(  # noqa: E731
            x.data_ptr(), gamma.data_ptr(), o_.data_ptr(), m, n, 1e-5, 1,
            stream)
        warp(libs["source"], ref)
        fields = {"warp": f"{_time_ms(torch, lambda: warp(libs['source'], out), flush):.6f}"}
        rows = st.norm_plan(m, n, st._sm_count(dev))
        arms = [("staged_bulk", "source", rows)] + [
            (f"staged_{name}", name, rows) for name in NORM_VARIANTS] + [
            (f"staged_bulk_rows{r}", "source", r) for r in (1, 2, 4, 8)
            if r != rows and m > 4]
        for label, name, r in arms:
            staged = lambda o_: libs[name].mxtt_stable_rms_norm_staged(  # noqa: E731
                x.data_ptr(), gamma.data_ptr(), o_.data_ptr(), m, n, r,
                1e-5, 1, stream)
            out.zero_()
            if staged(out):
                raise RuntimeError(f"staged norm launch failed ({label})")
            torch.cuda.synchronize()
            match = bool(torch.equal(out, ref))
            ok &= match
            fields[label] = (f"{_time_ms(torch, lambda: staged(out), flush):.6f}"
                             + ("" if match else "(differs)"))
        print(f"[s3] m={m} n={n} rows_a_block={rows} "
              + " ".join(f"{k_}_ms={v_}" for k_, v_ in fields.items()),
              flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
