#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with one GPU visible:

    python3 chip_smoke.py            # every phase; last line is the result
    python3 chip_smoke.py --quick    # phases 1-3 and 6 (builds + kernels)

Phases, each printed on its own line; the first failed check exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``); f32 matmuls
   must run in full f32 (``allow_tf32`` off).
2. build: compile the CUDA kernel libraries from ``mxnet_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together.
3. kernel: the decode-attention kernel against its plain PyTorch version
   on the card at Llama-3-8B shapes (H=32, KV=8, D=128; f32 and int8 rings),
   with its time, its bound, the plain version's time and, for f32, the
   time of one ``scaled_dot_product_attention`` call as a yardstick.
4. serve pallas / 5. serve int8: Llama-3-8B at full width and depth with
   seeded random weights, served by ``Generator`` (warmup, then 4 prompts x
   32 greedy tokens): every decode step of every layer must launch the
   kernel, no shape may be new after warmup, and the greedy tokens must be
   identical to a run with the plain attention forced.
6. flash: the three flash-attention kernels (forward, dq, dk/dv) each
   against its plain version at the training shape (B=2, H=32, T=2048,
   D=128, causal), non-causal with valid lengths [0, 1000] (dead rows must
   be exact zeros), causal with Tq != Tk, a ragged T=1000 and D=64; at the
   training shape each kernel's time, bound and plain time, and the
   ``scaled_dot_product_attention`` forward and backward as yardsticks;
   then the forward kernel against the library forward at T=512..4096.
7. train: Llama-3-8B width (units 4096, FFN 14336, 32 heads, 8 KV heads,
   vocab 128256) at depth 4 with seeded weights, three Adam steps of
   ``gluon.Trainer`` on one next-token batch (B=2, T=2048): every layer's
   attention must launch each flash kernel once a step, the loss must be
   finite and fall, and the losses and the parameters after three steps
   must match the same steps with the plain attention forced.

Then one JSON line of per-kernel numbers, the card's name and power limit,
and, last, the result line. Without CUDA, or without the package next to
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
CONFIG = "llama3_8b"
PROMPT_LENS = (17, 64, 130, 250)
NEW_TOKENS = 32
MAX_SEQ = 1024
ATOL, RTOL = 1e-5, 1e-4     # same f32 math, only the order of sums differs
SPIN_CYCLES = 4_000_000     # about 2 ms of the card's clock: covers host work
KERNEL_SOURCE = "mxnet_tpu_torch/csrc/decode_attention.cu"
REPLACES = "mxnet_tpu/ops/pallas/decode_attention.py:173"
FLASH_SOURCE = "mxnet_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {"fwd": "mxnet_tpu/ops/pallas/flash_attention.py:158",
                  "bwd_dq": "mxnet_tpu/ops/pallas/flash_attention.py:262",
                  "bwd_dkv": "mxnet_tpu/ops/pallas/flash_attention.py:350"}
# (B, H, Tq, Tk, D, causal, valid_length); the first is the training shape
FLASH_CASES = [(2, 32, 2048, 2048, 128, True, None),
               (2, 32, 2048, 2048, 128, False, [0, 1000]),
               (2, 32, 1024, 2048, 128, True, None),
               (2, 32, 1000, 1000, 128, True, None),
               (2, 32, 2048, 2048, 64, True, None)]
SWEEP_T = (512, 1024, 2048, 4096)
TRAIN_LAYERS, TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 4, 2, 2048, 3, 1e-4
# kernel route against forced-plain route after three Adam steps. Losses
# to 1e-4 (the attention differs by ~1e-6). The weights: each within 7 lr,
# the most Adam can move a weight apart in three steps (about lr a step
# each way) where a gradient within rounding of 0 takes the other sign on
# the other route; and the norm of the routes' difference within 1e-2 of
# the norm of how far the weights moved. Those sign flips alone gave
# 1.2e-3 on an H100 (a few hundred of 1.92 B weights 2 lr apart); a wrong
# attention gradient changes the update of every weight it reaches
LOSS_ATOL, PARAM_ATOL, PARAM_RTOL = 1e-4, 7 * TRAIN_LR, 1e-2


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps=25, warm=3):
    """Median device time of ``fn`` over ``reps`` launches, each timed by its
    own CUDA event pair, with the L2 cache flushed before each (in the
    decode step the ring of a layer is cold: 32 layers of weights pass
    through L2 between two reads of it). A spin kernel queued ahead of the
    first event keeps the card busy while the host enqueues ``fn``, so the
    pair times the device work and not the host's launch overhead."""
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


def kernel_bound(b_sp, kv, g, d, elem, quant):
    """Least time (ms) for one launch: bytes (q, out, start_pos, and the
    K/V rows up to each start_pos, plus int8 scales) over the memory rate,
    against flops (4 * G * D per position and KV head) over the f32 rate."""
    positions = sum(sp + 1 for sp in b_sp) * kv
    b = len(b_sp)
    nbytes = (2 * b * kv * g * d * 4 + 4 * b + positions * d * elem * 2
              + (positions * 8 if quant else 0))
    flops = positions * 4 * g * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, da, nn_ops, flush, dev):
    """Phase 3: kernel vs plain at Llama-3-8B attention shapes. Returns
    {variant: numbers at the main path's last decode step, max error}."""
    import torch.nn.functional as F

    h, kv, d = 32, 8, 128
    g = h // kv
    main_sp = [n + NEW_TOKENS - 2 for n in PROMPT_LENS]
    cases = []
    for quant in (False, True):
        for s in (1024, 1000):
            cases.append((quant, 1, s, [s - 1]))
            cases.append((quant, 4, s, [0, 100, s // 2 + 3, s - 1]))
        cases.append((quant, 4, MAX_SEQ, main_sp))
    results = {}
    seed = 0
    for quant, b, s, sps in cases:
        seed += 1
        gen = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn(b, h, 1, d, device=dev, generator=gen)
        kf = torch.randn(b, kv, s, d, device=dev, generator=gen)
        vf = torch.randn(b, kv, s, d, device=dev, generator=gen)
        sp = torch.tensor(sps, dtype=torch.int32, device=dev)
        if quant:
            zero = torch.zeros(b, dtype=torch.int32, device=dev)
            k = torch.zeros(b, kv, s, d, dtype=torch.int8, device=dev)
            v = torch.zeros_like(k)
            ks = torch.zeros(b, kv, s, device=dev)
            vs = torch.zeros_like(ks)
            nn_ops.kv_cache_write_q(k, ks, kf, zero)
            nn_ops.kv_cache_write_q(v, vs, vf, zero)
        else:
            k, v, ks, vs = kf, vf, None, None

        def kernel():
            return da.decode_attention(q, k, v, sp, k_scale=ks, v_scale=vs)

        def plain():
            return da.decode_attention_torch(q, k, v, sp, k_scale=ks,
                                             v_scale=vs)

        out = kernel()
        check(da.last_path() == "cuda", "kernel call did not take the kernel")
        torch.cuda.synchronize()
        ref = plain()
        err = (out - ref).abs()
        max_err = float(err.max())
        check(bool(torch.isfinite(out).all()), "kernel output not finite")
        check(bool((err <= ATOL + RTOL * ref.abs()).all()),
              f"kernel disagrees with plain: max_abs_err={max_err} "
              f"(quant={quant} B={b} S={s} start_pos={sps})")
        k_ms = time_ms(torch, kernel, flush)
        p_ms = time_ms(torch, plain, flush)
        lib_ms = None
        if not quant:
            valid = (torch.arange(s, device=dev)[None, :]
                     <= sp[:, None].long())[:, None, None, :]
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=valid, enable_gqa=True), flush)
        bound, bound_by = kernel_bound(sps, kv, g, d, 1 if quant else 4,
                                       quant)
        variant = "int8" if quant else "f32"
        say("kernel", variant=variant, B=b, S=s, start_pos=sps,
            max_abs_err=f"{max_err:.3e}", kernel_ms=f"{k_ms:.6f}",
            bound_ms=f"{bound:.6f}", bound_by=bound_by,
            plain_ms=f"{p_ms:.6f}",
            library_ms="null" if lib_ms is None else f"{lib_ms:.6f}")
        r = results.setdefault(variant, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], max_err)
        if b == 4 and s == MAX_SEQ and sps == main_sp:
            r.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                     bound_by=bound_by, library_ms=lib_ms)
    return results


def pairs_kept(b, h, tq, tk, causal, vl):
    """(query, key) pairs the masks keep: the work a flash kernel must do
    on these inputs."""
    off = tk - tq
    total = 0
    for kv in (vl if vl is not None else [tk] * b):
        kv = max(0, min(kv, tk))
        if causal:
            # sum over q of min(kv, max(0, q + off + 1))
            total += sum(min(kv, max(0, q + off + 1)) for q in range(tq))
        else:
            total += kv * tq
    return total * h


def flash_bound(kernel, b, h, tq, tk, d, causal, vl):
    """Least time (ms) of one launch: its inputs read and outputs written
    once over the memory rate, against its matrix-product flops on the
    kept pairs (fwd 4 D, dq 6 D, dk/dv 8 D a pair) over the f32 rate."""
    q_bytes, k_bytes = b * h * tq * d * 4, b * h * tk * d * 4
    rows = b * h * tq * 4
    nbytes = {"fwd": 2 * q_bytes + 2 * k_bytes + rows,
              "bwd_dq": 3 * q_bytes + 2 * k_bytes + 2 * rows,
              "bwd_dkv": 2 * q_bytes + 4 * k_bytes + 2 * rows}[kernel] + 4 * b
    flops = {"fwd": 4, "bwd_dq": 6, "bwd_dkv": 8}[kernel] * d * pairs_kept(
        b, h, tq, tk, causal, vl)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_phase(torch, fa, flush, dev):
    """Phase 6: each flash kernel against its plain version on the card.
    Returns {kernel: numbers at the training shape, max error}."""
    import torch.nn.functional as F

    results = {n: {"max_abs_err": 0.0} for n in fa.KERNELS}
    for case_i, (b, h, tq, tk, d, causal, vl) in enumerate(FLASH_CASES):
        gen = torch.Generator(device=dev).manual_seed(100 + case_i)

        def rnd(t):
            return torch.randn(b * h, t, d, device=dev, generator=gen)

        q, k, v, g = rnd(tq), rnd(tk), rnd(tk), rnd(tq)
        kvalid = fa.kvalid_of(None if vl is None else torch.tensor(vl), b,
                              tk, dev)
        args = (kvalid, causal, tk - tq, d ** -0.5)
        out, lse = fa.flash_fwd(q, k, v, *args)
        check(fa.last_path() == "cuda", "flash call did not take the kernel")
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_fwd_torch(q, k, v, *args)
        delta = (g * ref_out).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, g, ref_lse, delta, *args)
        dk, dv = fa.flash_bwd_dkv(q, k, v, g, ref_lse, delta, *args)
        torch.cuda.synchronize()
        ref_dq = fa.flash_bwd_dq_torch(q, k, v, g, ref_lse, delta, *args)
        ref_dk, ref_dv = fa.flash_bwd_dkv_torch(q, k, v, g, ref_lse, delta,
                                                *args)
        errs = {}
        for name, pairs in (("fwd", ((out, ref_out), (lse, ref_lse))),
                            ("bwd_dq", ((dq, ref_dq),)),
                            ("bwd_dkv", ((dk, ref_dk), (dv, ref_dv)))):
            err = 0.0
            for ours, ref in pairs:
                check(bool(torch.isfinite(ours).all()),
                      f"flash {name} output not finite")
                diff = (ours - ref).abs()
                check(bool((diff <= ATOL + RTOL * ref.abs()).all()),
                      f"flash {name} disagrees with plain: max_abs_err="
                      f"{float(diff.max())} (case {case_i})")
                err = max(err, float(diff.max()))
            errs[name] = err
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)
        dead = ref_lse <= -1e29
        n_dead = int(dead.sum())
        check(bool(torch.equal(lse <= -1e29, dead))
              and bool((lse[dead] == -1e30).all())
              and not bool(out[dead].any()) and not bool(dq[dead].any()),
              f"flash dead rows are not exact zeros (case {case_i})")
        if vl is not None and vl[0] == 0:
            check(n_dead == h * tq and not bool(dk[:h].any())
                  and not bool(dv[:h].any()),
                  "flash: a batch row with valid length 0 has gradients")
        check(bool(dq.abs().max() > 0) and bool(dk.abs().max() > 0),
              "flash gradients are all zero")
        say("flash", B=b, H=h, Tq=tq, Tk=tk, D=d, causal=causal,
            valid_length=vl, dead_rows=n_dead,
            **{f"{n}_max_abs_err": f"{e:.3e}" for n, e in errs.items()})
        if case_i:
            continue
        # the training shape: times
        calls = {"fwd": lambda: fa.flash_fwd(q, k, v, *args),
                 "bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, g, ref_lse,
                                                   delta, *args),
                 "bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, g, ref_lse,
                                                     delta, *args)}
        plains = {"fwd": lambda: fa.flash_fwd_torch(q, k, v, *args),
                  "bwd_dq": lambda: fa.flash_bwd_dq_torch(
                      q, k, v, g, ref_lse, delta, *args),
                  "bwd_dkv": lambda: fa.flash_bwd_dkv_torch(
                      q, k, v, g, ref_lse, delta, *args)}
        q4, k4, v4, g4 = (x.view(b, h, -1, d) for x in (q, k, v, g))
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), flush)
        qr, kr, vr = (x.detach().clone().requires_grad_()
                      for x in (q4, k4, v4))
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), g4, retain_graph=True), flush)

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
            torch.autograd.grad(o, (qr, kr, vr), g4)

        lib_both = time_ms(torch, lib_fwd_bwd, flush)
        for name in fa.KERNELS:
            k_ms = time_ms(torch, calls[name], flush)
            p_ms = time_ms(torch, plains[name], flush)
            bound, bound_by = flash_bound(name, b, h, tq, tk, d, causal, vl)
            lib_ms = lib_fwd if name == "fwd" else lib_bwd
            results[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                                 bound_by=bound_by, library_ms=lib_ms)
            say("flash", kernel=name, B=b, H=h, T=tq, D=d, causal=causal,
                kernel_ms=f"{k_ms:.6f}", bound_ms=f"{bound:.6f}",
                bound_by=bound_by, plain_ms=f"{p_ms:.6f}",
                library_ms=f"{lib_ms:.6f}",
                library=("sdpa_forward" if name == "fwd"
                         else "sdpa_backward_dq_dk_dv"))
        say("flash", library_fwd_bwd_ms=f"{lib_both:.6f}",
            kernels_fwd_bwd_ms=f"{sum(results[n]['ms'] for n in fa.KERNELS):.6f}")
        del qr, kr, vr, lib_out
    # crossover record: forward kernel against the library forward
    for t in SWEEP_T:
        b, h, d = 2, 32, 128
        gen = torch.Generator(device=dev).manual_seed(t)
        q, k, v = (torch.randn(b * h, t, d, device=dev, generator=gen)
                   for _ in range(3))
        kvalid = fa.kvalid_of(None, b, t, dev)
        k_ms = time_ms(torch, lambda: fa.flash_fwd(q, k, v, kvalid, True, 0,
                                                   d ** -0.5), flush, reps=10)
        q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
        l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), flush, reps=10)
        bound, _ = flash_bound("fwd", b, h, t, t, d, True, None)
        say("flash sweep", B=b, H=h, T=t, D=d, causal=True,
            kernel_ms=f"{k_ms:.6f}", library_ms=f"{l_ms:.6f}",
            bound_ms=f"{bound:.6f}")
    return results


def train_run(torch, mt, fa, get_llama, Trainer, loss_mod, dev, route,
              toks, keep_initial):
    """Three Adam steps of the 4-layer Llama-3-8B-width model on ``toks``
    with the attention on ``route`` (None: the kernels; "torch": plain).
    Returns (losses, step ms, launches, peak bytes, params on the host,
    initial params on the host or None)."""
    mt.random.seed(0)
    model = get_llama(CONFIG, device=dev, trainable=True,
                      num_layers=TRAIN_LAYERS)
    initial = ({n: p.detach().to("cpu", copy=True)
                for n, p in model.named_parameters()}
               if keep_initial else None)
    trainer = Trainer(model.parameters(), "adam",
                      {"learning_rate": TRAIN_LR})
    loss_fn = loss_mod.SoftmaxCrossEntropyLoss()
    x = torch.from_numpy(toks[:, :-1]).to(dev)
    y = torch.from_numpy(toks[:, 1:]).to(dev)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.force_path(route)
    fa.reset_launch_count()
    try:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss = loss_fn(model(x), y)
            loss.sum().backward()          # MXNet's loss.backward()
            trainer.step(TRAIN_B)
            losses.append(float(loss.detach().mean()))  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        fa.force_path(None)
    launches = fa.launch_count()
    peak = torch.cuda.max_memory_allocated()
    final = {n: p.detach().to("cpu", copy=True)
             for n, p in model.named_parameters()}
    del model, trainer, loss, x, y
    torch.cuda.empty_cache()
    return losses, step_ms, launches, peak, final, initial


def train_phase(torch, np, mt, fa, get_llama, Trainer, loss_mod, dev, vocab):
    """Phase 7: train Llama-3-8B width at depth 4 on the kernel route, then
    the same steps with the plain attention forced; returns the kernel
    route's launches."""
    toks = np.random.RandomState(0).randint(
        0, vocab, size=(TRAIN_B, TRAIN_T + 1)).astype(np.int64)
    runs = {}
    for route in (None, "torch"):
        losses, step_ms, launches, peak, final, initial = train_run(
            torch, mt, fa, get_llama, Trainer, loss_mod, dev, route, toks,
            keep_initial=route is None)
        label = "kernel" if route is None else "plain"
        tok_s = TRAIN_B * TRAIN_T / (statistics.mean(step_ms[1:]) / 1e3)
        say("train", route=label, layers=TRAIN_LAYERS, B=TRAIN_B,
            T=TRAIN_T, losses=[f"{x:.6f}" for x in losses],
            step_ms=[f"{x:.3f}" for x in step_ms],
            tokens_s=f"{tok_s:.3f}", peak_mem_bytes=peak,
            launches=launches)
        check(all(np.isfinite(losses)), f"{label} route: loss not finite")
        check(losses[-1] < losses[0], f"{label} route: loss did not fall "
              f"({losses})")
        runs[label] = (losses, launches, final, initial)
    k_losses, k_launches, k_final, initial = runs["kernel"]
    p_losses, p_launches, p_final, _ = runs["plain"]
    want = TRAIN_LAYERS * TRAIN_STEPS
    check(k_launches == dict.fromkeys(fa.KERNELS, want),
          f"kernel route launched {k_launches}, want {want} of each")
    check(p_launches == dict.fromkeys(fa.KERNELS, 0),
          f"plain route launched the kernels: {p_launches}")
    loss_diff = max(abs(a - b) for a, b in zip(k_losses, p_losses))
    max_diff, diff_sq, moved_sq = 0.0, 0.0, 0.0
    for name, pk in k_final.items():
        pk, pp, p0 = (t.to(dev) for t in (pk, p_final[name], initial[name]))
        max_diff = max(max_diff, float((pk - pp).abs().max()))
        diff_sq += float(((pk - pp).double() ** 2).sum())
        moved_sq += float(((pk - p0).double() ** 2).sum())
    rel = (diff_sq / moved_sq) ** 0.5 if moved_sq else float("inf")
    say("train", loss_max_diff=f"{loss_diff:.3e}",
        param_max_abs_diff=f"{max_diff:.3e}",
        param_diff_over_movement=f"{rel:.3e}",
        params=sum(t.numel() for t in k_final.values()))
    check(loss_diff <= LOSS_ATOL, f"losses differ from the plain route by "
          f"{loss_diff} > {LOSS_ATOL}")
    check(max_diff <= PARAM_ATOL and rel <= PARAM_RTOL,
          f"parameters differ from the plain route: max {max_diff} "
          f"(limit {PARAM_ATOL}), relative {rel} (limit {PARAM_RTOL})")
    return k_launches


def first_divergence(torch, da, gen, prompts, a, b):
    """Row and step of the first differing greedy token of the kernel run
    ``a`` and the plain run ``b``, with each route's logit gap between the
    two candidates there (both routes replay the plain run's tokens)."""
    row, step = next((i, j) for j in range(NEW_TOKENS)
                     for i in range(len(a)) if a[i][j:j + 1] != b[i][j:j + 1])
    ta, tb = a[row][step], b[row][step]
    logits = {}
    for route in (None, "torch"):
        da.force_path(route)
        try:
            toks, lens, bb = gen._pad_prompts(prompts)
            lg, cache = gen.prefill(toks, lens, gen._fresh_cache(bb))
            pos = lens.copy()
            for j in range(step):
                ids = [b[r][j] if r < len(b) else 0 for r in range(bb)]
                lg, cache = gen.decode_step(ids, pos, cache)
                pos = pos + 1
        finally:
            da.force_path(None)
        logits[route] = lg[row].float()
    gap_k = float(logits[None][ta] - logits[None][tb])
    gap_p = float(logits["torch"][ta] - logits["torch"][tb])
    diff = float((logits[None] - logits["torch"]).abs().max())
    return (f"row={row} step={step} kernel_token={ta} plain_token={tb} "
            f"kernel_gap={gap_k:.6e} plain_gap={gap_p:.6e} "
            f"max_logit_diff={diff:.6e}")


def serve_phase(torch, da, Generator, model, rung, prompts, n_layers, vocab):
    """Phases 4/5: serve the prompts on one rung; returns its numbers."""
    phase = f"serve {rung}"
    gen = Generator(model, max_seq=MAX_SEQ, batch_buckets=(1, 4),
                    prompt_buckets=(64, 256), decode_path=rung,
                    name=f"llama3_8b_{rung}")
    w = gen.warmup()
    say(phase, warmup_s=f"{w['wall_s']:.3f}", signatures=w["signatures"])
    toks, lens, bb = gen._pad_prompts(prompts)
    logits, _ = gen.prefill(toks, lens, gen._fresh_cache(bb))
    check(tuple(logits.shape) == (bb, vocab),
          f"prefill logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")

    da.force_path(None)
    da.reset_launch_count()
    out, info = gen.generate(prompts, max_new_tokens=NEW_TOKENS)
    launches = da.launch_count()
    steps = info["decode_steps"]
    check(steps == NEW_TOKENS - 1, f"{steps} decode steps")
    check(all(len(o) == NEW_TOKENS for o in out), "short output")
    check(launches == n_layers * steps,
          f"{launches} kernel launches for {steps} decode steps x "
          f"{n_layers} layers")
    gen.assert_no_recompiles()
    say(phase, prefill_ms=f"{info['prefill_ms']:.3f}",
        decode_ms_per_token=f"{info['decode_ms'] / steps:.3f}",
        tokens_s=f"{info['tokens_s']:.3f}", decode_steps=steps,
        kernel_launches=launches, kv_cache_bytes=gen.kv_cache_bytes(),
        peak_mem_bytes=torch.cuda.max_memory_allocated())

    da.force_path("torch")
    try:
        out_plain, info_plain = gen.generate(prompts,
                                             max_new_tokens=NEW_TOKENS)
    finally:
        da.force_path(None)
    check(da.launch_count() == launches,
          "forced-plain run launched the kernel")
    gen.assert_no_recompiles()
    if out != out_plain:
        raise CheckFailed(f"{rung}: greedy tokens differ from the plain run: "
                          + first_divergence(torch, da, gen, prompts, out,
                                             out_plain))
    say(phase, tokens_identical_to_plain=True,
        plain_decode_ms_per_token=f"{info_plain['decode_ms'] / steps:.3f}",
        first_tokens=[o[:4] for o in out])
    return {"launches": launches, "info": info}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="run phases 1-3 and 6 only (builds and kernels)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "mxnet_tpu_torch")):
        print(f"chip_smoke: no mxnet_tpu_torch package next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import numpy as np

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon import loss as loss_mod
    from mxnet_tpu_torch.models import get_llama
    from mxnet_tpu_torch.models.llama import _LLAMA_CONFIGS
    from mxnet_tpu_torch.ops import nn as nn_ops
    from mxnet_tpu_torch.ops.hopper import _build
    from mxnet_tpu_torch.ops.hopper import decode_attention as da
    from mxnet_tpu_torch.ops.hopper import flash_attention as fa
    from mxnet_tpu_torch.serve import Generator

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("device", kind=json.dumps(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    print(f"nvidia-smi: {smi}", flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "allow_tf32 is on: f32 matmuls would run in TF32")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = ("decode_attention", "flash_attention")
    _build.build_many(sources)
    da.build()
    fa.build()
    for name in sources:
        log = _build.BUILD_LOGS.get(name)
        say("build", source=name,
            seconds=f"{log['seconds']:.3f}" if log else "cached",
            library=os.path.relpath(_build.library_path(name), root))
        for line in (log["log"].splitlines() if log else []):
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    say("build", seconds=f"{time.perf_counter() - t0:.3f}",
        natural_block=da.natural_block())

    # 3. kernel vs plain
    flush = torch.empty(64 << 18, device=dev)  # 64 MiB > the 50 MB L2
    kres = kernel_phase(torch, da, nn_ops, flush, dev)
    if args.quick:
        flash_phase(torch, fa, flush, dev)
        say("quick", seconds=f"{time.perf_counter() - t_start:.3f}")
        return 0
    del flush

    # 4./5. serve llama3_8b on the pallas and int8 rungs
    cfg = _LLAMA_CONFIGS[CONFIG]
    mt.random.seed(0)
    t0 = time.perf_counter()
    model = get_llama(CONFIG, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say("model", config=CONFIG, layers=cfg["num_layers"],
        units=cfg["units"], vocab=cfg["vocab_size"], params=n_params,
        init_s=f"{time.perf_counter() - t0:.3f}")
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, cfg["vocab_size"], size=n)]
               for n in PROMPT_LENS]
    served = {}
    for rung in ("pallas", "int8"):
        served[rung] = serve_phase(torch, da, Generator, model, rung, prompts,
                                   cfg["num_layers"], cfg["vocab_size"])
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 6. flash kernels vs plain
    flush = torch.empty(64 << 18, device=dev)
    fres = flash_phase(torch, fa, flush, dev)
    del flush
    gc.collect()
    torch.cuda.empty_cache()

    # 7. train llama3_8b width at depth 4 on both attention routes
    train_launches = train_phase(torch, np, mt, fa, get_llama, Trainer,
                                 loss_mod, dev, cfg["vocab_size"])

    kernels = []
    for variant, rung in (("f32", "pallas"), ("int8", "int8")):
        r = kres[variant]
        kernels.append({
            "name": f"decode_attention_{variant}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": served[rung]["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for name in fa.KERNELS:
        r = fres[name]
        kernels.append({
            "name": f"flash_{name}", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[name],
            "launches": train_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    say("done", seconds=f"{time.perf_counter() - t_start:.3f}")
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
