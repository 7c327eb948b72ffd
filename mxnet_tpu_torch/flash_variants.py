"""Build text-edited variants of the flash-attention kernels side by side
and time them in turns on one card.

    python -m mxnet_tpu_torch.flash_variants

A variant is ``mxnet_tpu_torch/csrc/flash_attention.cu`` with some text
replaced (every replaced text must occur in the source), built with
``nvcc`` for the (bf16, bf16) pair into ``build/flash_variants/``,
one process each, all started together. For each variant the script prints
its kernels' attributes (registers, local bytes and blocks an SM at D = 64,
128 and 256, 16-byte copies), holds its forward, dq and dk/dv kernels
against their plain versions at BERT-base's attention shape and the Llama
training shape (within ATOL / RTOL plus one unit in the last place, two
calls bit for bit; a diagnostic variant that drops work fails this and is
timed all the same), and times each kernel at both shapes: the median of
25 launches timed by CUDA events with the L2 cache flushed before each,
over two rounds, the second in reverse order. One
``scaled_dot_product_attention`` forward and one backward in the pair's
dtype are timed beside them. The first line is the card's name and power
limit; each variant's line gives its times, and a last line per shape the
variants' best forward and backward (dq + dk/dv) times.

The variants of the (bf16, bf16) kernels: ``source``; for the forward,
``fwd_keys64`` (64-key tiles, where the source streams 32),
``fwd_three_blocks`` and ``fwd_two_blocks`` (registers held to three or
two blocks an SM at D = 64, where the source asks for four),
``fwd_five_blocks`` (five at D = 64, output tiles in groups of 4 rather
than 8), ``fwd_two_stages`` (two stages of K and V, where the source has
three), ``fwd_rescale_apart`` (the output rows rescaled by alpha before the
tile's product is added, where the source joins them in one fmaf),
``fwd_divide`` and ``fwd_reciprocal`` (out / l by a division, or by the
product with the rounded 1 / l alone, where the source corrects that
product to the division's rounding with two fmaf), ``fwd_score_chunk64``
(the score summed 64 columns apart, where the source sums 32) and
``fwd_exp2f`` (P by ``exp2f`` rather than ``ex2.approx.ftz``); for the
backward, ``two_dq_blocks`` (two dq blocks an SM at D = 128, where the
source holds three) and ``head_major_causal`` (causal grids in a
head's-tiles-together order too, as the non-causal ones); and diagnostics
that each drop one part of the work of all three kernels:
``no_score_mma``, ``no_output_mma``, ``no_ldmatrix`` (fragments from
registers), ``no_split`` (one real bf16 piece of P and dS, two dummy ones),
``no_exp2``, ``no_copies`` (no global-to-shared copies).
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time

_SCORE_MMA = """        mma_bf16(ts[j], fa1, f1[0], f1[2]);
        mma_bf16(ts[j + 1], fa1, f1[1], f1[3]);
        mma_bf16(tp[j], fa2, f2[0], f2[2]);
        mma_bf16(tp[j + 1], fa2, f2[1], f2[3]);
"""
_SCORE_MMA_FWD = """        mma_bf16(ts[j], fa, f[0], f[2]);
        mma_bf16(ts[j + 1], fa, f[1], f[3]);
"""
_OUTPUT_MMA = """        mma3_bf16(part[n], xa[i], b[0], b[1]);
        mma3_bf16(part[n + 1], xa[i], b[2], b[3]);
"""
# keeps the pieces and the fragments live without a product
_OUTPUT_SINK = """        part[n][0] += __uint_as_float(xa[i].hi[n & 3] ^ xa[i].mid[n & 3] ^
                                      xa[i].lo[n & 3] ^ b[0] ^ b[1] ^ b[2] ^ b[3]);
"""
_LDSM = ('''  asm volatile("ldmatrix.sync.aligned.m8n8.x4{}.shared.b16 '''
         '''{{%0, %1, %2, %3}}, [%4];\\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));''')
_LDSM_FAKE = "  r[0] = addr; r[1] = addr + 1; r[2] = addr + 2; r[3] = addr + 3;"
_SPLIT = """  x -= __uint_as_float(hi << 16);
  y -= __uint_as_float(hi & 0xffff0000u);
  mid = pack_bf16(x, y);
  x -= __uint_as_float(mid << 16);
  y -= __uint_as_float(mid & 0xffff0000u);
  lo = pack_bf16(x, y);"""
_EXP_DQ = "exp2f(fmaf(s[j][c], scale * kLog2e, -lr[h] * kLog2e))"
_EXP_DKV = "exp2f(fmaf(s[j][c], scale * kLog2e, -lq * kLog2e))"
_EXP_FWD = "ex2_ftz(fmaf(s[j][c], sl, -mb[h]))"
_FWD_QUOTIENT = "acc[n][2 * h + e] = fmaf(fmaf(-qt, lsafe, x), rl, qt);"
_FWD_BLOCKS = ("__launch_bounds__(kThreads16, P <= 64 && VEC ? 4 : P <= 128 "
               "? 3 : 2)")
_COPY = ("      cp_async16(dst + swz16<P>(r, c), in ? src + "
         "static_cast<size_t>(r0 + r) * D + c : src, in);")
_ORDER_DQ = (
    "  const int bh = causal ? blockIdx.x % n_bh : blockIdx.x / n_qt;\n"
    "  const int q0 = (n_qt - 1 - (causal ? blockIdx.x / n_bh : "
    "blockIdx.x % n_qt)) * BM;")
_ORDER_DKV = (
    "  const int bh = causal ? blockIdx.x % n_bh : blockIdx.x / n_kt;\n"
    "  const int k0 = (causal ? blockIdx.x / n_bh : blockIdx.x % n_kt) * BN;")

KERNELS = ("fwd", "bwd_dq", "bwd_dkv")
VARIANTS = {
    "source": [],
    "fwd_keys64": [("static constexpr int SFWD = 32;",
                    "static constexpr int SFWD = 64;")],
    "fwd_three_blocks": [(_FWD_BLOCKS, "__launch_bounds__(kThreads16, "
                                       "P <= 128 ? 3 : 2)")],
    "fwd_two_blocks": [(_FWD_BLOCKS, "__launch_bounds__(kThreads16, 2)")],
    "fwd_five_blocks": [
        (_FWD_BLOCKS, "__launch_bounds__(kThreads16, P <= 64 && VEC ? 5 : "
                      "P <= 128 ? 3 : 2)"),
        ("add_product16<P, BN, NO, (NO < 8 ? NO : 8), true>",
         "add_product16<P, BN, NO, (NO < 4 ? NO : 4), true>")],
    "fwd_divide": [(_FWD_QUOTIENT, "acc[n][2 * h + e] = x / lsafe;")],
    "fwd_reciprocal": [(_FWD_QUOTIENT, "acc[n][2 * h + e] = qt;")],
    "fwd_rescale_apart": [(
        "      add_product16<P, BN, NO, (NO < 8 ? NO : 8), true>(acc, s, v_a, "
        "lo, c0, D, alpha);",
        "      for (int n = 0; n < NO; ++n)\n        for (int c = 0; c < 4; "
        "++c) acc[n][c] *= alpha[c >> 1];\n      add_product16<P, BN, NO, "
        "(NO < 8 ? NO : 8)>(acc, s, v_a, lo, c0, D);")],
    "fwd_score_chunk64": [("score16<P, BN, kChunk16Dq>(s, qa_s, k_a, lo, D);",
                           "score16<P, BN, 4>(s, qa_s, k_a, lo, D);")],
    "fwd_exp2f": [(_EXP_FWD, "exp2f" + _EXP_FWD[7:])],
    "fwd_two_stages": [("static constexpr int STAGES_FWD = 3;",
                        "static constexpr int STAGES_FWD = 2;")],
    "two_dq_blocks": [(
        "__launch_bounds__(kThreads16, P <= 128 ? 3 : 2)",
        "__launch_bounds__(kThreads16, P <= 64 ? 3 : 2)")],
    "head_major_causal": [
        (_ORDER_DQ, "  const int bh = blockIdx.x / n_qt;\n"
                    "  const int q0 = (n_qt - 1 - blockIdx.x % n_qt)"
                    " * BM;"),
        (_ORDER_DKV, "  const int bh = blockIdx.x / n_kt;"
                     "\n  const int k0 = blockIdx.x % n_kt * BN;")],
    "no_score_mma": [(_SCORE_MMA, ""), (_SCORE_MMA_FWD, "")],
    "no_output_mma": [(_OUTPUT_MMA, _OUTPUT_SINK)],
    "no_ldmatrix": [(_LDSM.format(""), _LDSM_FAKE),
                    (_LDSM.format(".trans"), _LDSM_FAKE)],
    "no_split": [(_SPLIT, "  mid = hi ^ 1u;\n  lo = hi ^ 2u;")],
    "no_exp2": [(_EXP_DQ, _EXP_DQ[6:-1]), (_EXP_DKV, _EXP_DKV[6:-1]),
                (_EXP_FWD, _EXP_FWD[8:-1])],
    "no_copies": [(_COPY, "      (void)in;")],
}

ATOL, RTOL = 1e-5, 1e-4
SPIN_CYCLES = 4_000_000   # about 2 ms of the card's clock: covers host work
BERT_VL = [112 if i % 4 == 0 else 128 for i in range(64)]
BERT_VL[1] = 0
# name: (B, H, Tq, Tk, D, causal, valid lengths)
SHAPES = {"bert": (64, 12, 128, 128, 64, False, BERT_VL),
          "llama": (2, 32, 2048, 2048, 128, True, None)}


def variant_source(source: str, subs) -> str:
    """``source`` with every ``(old, new)`` of ``subs`` replaced; raises
    ``ValueError`` naming a text that does not occur."""
    for old, new in subs:
        if old not in source:
            raise ValueError(f"variant text not in the source: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def _nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, flush, reps=25, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _ulp(torch, x, dtype):
    """One unit in the last place of ``dtype`` at |x| (0 for f32)."""
    if dtype == torch.float32:
        return torch.zeros_like(x)
    mant, lo = (7, -126) if dtype == torch.bfloat16 else (10, -14)
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), torch.clamp(e - 1, min=lo) - mant)


def _build(names_sources, defines, out_dir):
    """Compile each (name, source text) with ``nvcc``, all at once; returns
    {name: ctypes.CDLL}, printing the compiler's output of a failed one."""
    from .ops.hopper import _build as build

    nvcc = build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in names_sources:
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
             str(out_dir / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"[variant] name={name} build_failed\n{log[-4000:]}",
                  flush=True)
            continue
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 7 + [ctypes.c_float, ptr]
        lib.mxtt_flash_bwd_dq.argtypes = [ptr] * 8 + tail
        lib.mxtt_flash_bwd_dkv.argtypes = [ptr] * 9 + tail
        lib.mxtt_flash_fwd.argtypes = [ptr] * 6 + tail
        lib.mxtt_flash_kernel_attributes.argtypes = [
            i32, i32, i32, ctypes.POINTER(i32)]
        libs[name] = lib
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: CUDA is not available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from .ops.hopper import _build as build
    from .ops.hopper import flash_attention as fa

    dtype = torch.bfloat16
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    source = (build.CSRC / "flash_attention.cu").read_text()
    t0 = time.perf_counter()
    libs = _build([(n, variant_source(source, subs))
                   for n, subs in VARIANTS.items()],
                  fa.build_spec((dtype, dtype))[1],
                  build.BUILD_DIR.parent / "flash_variants")
    print(f"[variant] built={len(libs)} seconds="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    out = (ctypes.c_int * 5)()
    for name, lib in libs.items():
        fields = []
        for d in (64, 128, 256):
            for kernel, label in enumerate(fa.KERNELS):
                lib.mxtt_flash_kernel_attributes(kernel, d, 1, out)
                fields.append(f"{label}{d}={out[0]}/{out[1]}/{out[2]}")
        print(f"[variant] name={name} registers/local_bytes/blocks_per_sm "
              + " ".join(fields), flush=True)

    flush = torch.empty(64 << 18, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (b, h, tq, tk, d, causal, vl) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(9)
        q = torch.randn(b * h, tq, d, device=dev, generator=gen).to(dtype)
        k, v = (torch.randn(b * h, tk, d, device=dev, generator=gen).to(dtype)
                for _ in range(2))
        g = torch.randn(b * h, tq, d, device=dev, generator=gen).to(dtype)
        kvalid = fa.kvalid_of(None if vl is None else torch.tensor(vl), b,
                              tk, dev)
        args = (kvalid, causal, tk - tq, d ** -0.5)
        ref_out, lse = fa.flash_fwd_torch(q, k, v, *args)
        delta = (g.float() * ref_out.float()).sum(-1)
        refs = {"fwd": (ref_out, lse),
                "bwd_dq": (fa.flash_bwd_dq_torch(q, k, v, g, lse, delta,
                                                 *args),),
                "bwd_dkv": fa.flash_bwd_dkv_torch(q, k, v, g, lse, delta,
                                                  *args)}
        ints = (b * h, h, tq, tk, d, int(causal), tk - tq)
        ptrs = [x.data_ptr() for x in (q, k, v, g, lse, delta, kvalid)]

        def calls(lib):
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            out, lse_out = torch.empty_like(q), torch.empty_like(lse)
            return {
                "fwd": ((out, lse_out), lambda: lib.mxtt_flash_fwd(
                    *ptrs[:3], kvalid.data_ptr(), out.data_ptr(),
                    lse_out.data_ptr(), *ints, d ** -0.5, stream)),
                "bwd_dq": ((dq,), lambda: lib.mxtt_flash_bwd_dq(
                    *ptrs, dq.data_ptr(), *ints, d ** -0.5, stream)),
                "bwd_dkv": ((dk, dv), lambda: lib.mxtt_flash_bwd_dkv(
                    *ptrs, dk.data_ptr(), dv.data_ptr(), *ints, d ** -0.5,
                    stream))}

        times = {}
        for name, lib in libs.items():
            ok = True
            for kernel in KERNELS:
                outs, fn = calls(lib)[kernel]
                fn()
                first = [x.clone() for x in outs]
                err = fn()
                torch.cuda.synchronize()
                ok = ok and err == 0 and all(
                    torch.equal(a, c) for a, c in zip(outs, first))
                for ours, ref in zip(outs, refs[kernel]):
                    a, r = ours.float(), ref.float()
                    diff = (a - r).abs()
                    bound = ATOL + RTOL * r.abs() + _ulp(
                        torch, torch.maximum(a.abs(), r.abs()), ours.dtype)
                    ok = ok and bool((diff <= bound).all())
            print(f"[variant] name={name} shape={shape} "
                  f"matches_plain={ok}", flush=True)
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                for kernel in KERNELS:
                    _, fn = calls(libs[name])[kernel]
                    times.setdefault((name, kernel), []).append(
                        _time_ms(torch, fn, flush))
        for name in libs:
            print(f"[variant] name={name} shape={shape} " + " ".join(
                f"{kernel}_ms=" + "/".join(f"{x:.6f}" for x in
                                           times[(name, kernel)])
                for kernel in KERNELS), flush=True)
        q4, k4, v4, g4 = (x.view(b, h, -1, d) for x in (q, k, v, g))
        qr, kr, vr = (x.detach().clone().requires_grad_()
                      for x in (q4, k4, v4))
        mask = None if vl is None else (
            torch.arange(tk, device=dev)[None, :]
            < torch.tensor(vl, device=dev)[:, None])[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                                 is_causal=causal)
        lib_ms = _time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), g4, retain_graph=True), flush)
        lib_fwd_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, is_causal=causal), flush)
        print(f"[variant] shape={shape} sdpa_forward_ms={lib_fwd_ms:.6f} "
              + " ".join(f"{n}={min(times[(n, 'fwd')]):.6f}" for n in libs),
              flush=True)
        best = {n: sum(min(times[(n, kk)]) for kk in KERNELS[1:])
                for n in libs}
        print(f"[variant] shape={shape} sdpa_backward_ms={lib_ms:.6f} "
              + " ".join(f"{n}={ms:.6f}" for n, ms in best.items()),
              flush=True)
        del q, k, v, g, qr, kr, vr, lib_out, refs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
