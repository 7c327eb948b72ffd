"""Where a decode step's time goes: Llama-3-8B served by ``Generator`` on
one GPU.

    python -m mxnet_tpu_torch.profile_decode [--rung pallas|int8] [--steps N]
        [--multistep] [--speculative] [--prefill]

For each rung: warm the generator up, then

* time whole decode steps on the host clock (each step ends in the host
  read of the sampled ids), with attention through the CUDA kernel and
  with the plain version forced, in turns kernel, plain, plain, kernel;
* trace ``--steps`` kernel-route decode steps with ``torch.profiler`` and
  sum the device time by kernel name, giving the device busy share of the
  step and the kernels that fill it.

With ``--multistep``, also a multi-step ``Generator``
(``MXNET_SERVE_DECODE_STEPS`` iterations a visit, default 8, on CUDA
graphs): ``--steps`` super-steps after one prefill, each timed on the
device (CUDA events around the graph replay) and on the host (from the
input copy to the host read of the token block), giving device ms a visit
and a token, host wall ms a visit, and the busy share (device over host);
then two visits under ``torch.profiler``, the graph's kernels back to back,
giving the int8 kernels' device ms a token step (``graph_int8_*``) and the
union of every kernel's intervals a token step.

With ``--speculative``, also a ``SpeculativeGenerator`` (k = 4, a
multi-step draft: a seeded random 2-layer model of the same widths) over
the same target: ``--steps`` verify replays and draft replays after one
prefill, each timed on the device (CUDA events around the replay), and
``--steps`` passes of the verify body run eagerly under ``torch.profiler``
with the device time summed by kernel name (the kernels the graph
replays), beside the single-step profile's T = 1 step.

With ``--prefill``, the prefill alone in place of the decode steps: the
4 prompts padded to (4, 256), ``--steps`` prefills each timed on the host
clock to a synchronisation, and ``--steps`` more under ``torch.profiler``
with the device time summed by kernel name and the busy share.

On the ``int8`` rung the projections run the int8 x int8 kernels
(``ops/hopper/int8_dense``: int8 weights are on for the card under
``MXNET_SERVE_DECODE_INT8_WEIGHTS=auto``); each profile then also gives
their device ms a step (the row quantization, the product and the split's
sum, 225 calls a forward) beside the other kernels: summed by kernel, and
as the union of their intervals on the device (``_union``), since the
decode route's product and sum start early under programmatic dependent
launch and wait on the card, so their durations overlap. The step's
device time is given both ways too.

Prints one JSON object per rung and mode. Weights are random (seeded); the batch is
4 prompts of lengths 17, 64, 130 and 250 in a 1024-position ring, as in
``chip_smoke.py``. Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time

import numpy as np
import torch

from . import random as _rng
from .models import get_llama
from .models.llama import _LLAMA_CONFIGS
from .ops.hopper import decode_attention as da
from .serve import Generator

PROMPT_LENS = (17, 64, 130, 250)


def _decode_walls(gen, prompts, steps, route):
    """Host wall time (ms) of each of ``steps`` decode steps after a
    prefill, attention routed by ``route``."""
    da.force_path(route)
    try:
        toks, lens, bb = gen._pad_prompts(prompts)
        logits, cache = gen.prefill(toks, lens, gen._fresh_cache(bb))
        ids = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        pos = lens.copy()
        walls = []
        for _ in range(steps):
            t0 = time.perf_counter()
            logits, cache = gen.decode_step(ids, pos, cache)
            ids = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
            walls.append((time.perf_counter() - t0) * 1e3)
            pos = pos + 1
        return walls
    finally:
        da.force_path(None)


def _profile(gen, prompts, steps):
    """Device time by kernel name over ``steps`` kernel-route decode
    steps, and the host wall they took."""
    toks, lens, bb = gen._pad_prompts(prompts)
    logits, cache = gen.prefill(toks, lens, gen._fresh_cache(bb))
    state = {"ids": torch.argmax(logits, -1).to(torch.int32).cpu().numpy(),
             "pos": lens.copy(), "cache": cache}

    def step():
        logits, state["cache"] = gen.decode_step(state["ids"], state["pos"],
                                                 state["cache"])
        state["ids"] = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        state["pos"] = state["pos"] + 1

    spans = {}
    return (*_kernel_times(step, steps, spans), spans)


def _union_ms(spans):
    """Milliseconds of the union of (start, end) intervals in microseconds:
    the time at least one of them ran."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (total + (hi - lo if hi is not None else 0.0)) / 1e3


def _kernel_times(step, steps, spans):
    """Run ``step`` ``steps`` times under ``torch.profiler``; returns the
    host wall (ms) and ``{kernel name: (device ms, calls)}``, and fills
    ``spans`` with each kernel's (start, end) on the device, in
    microseconds, by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = (dev_us / 1e3, ev.count)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    return wall_ms, by_name


def _int8_split(by_name, steps, spans):
    """Device ms and kernel calls a step of the int8 product's kernels
    (names containing ``int8_``), by kernel and together: summed, and as
    the union of their intervals on the device (``_union``). Under
    programmatic dependent launch a kernel starts while the one before it
    runs and waits on the card, so its duration overlaps the other's and
    the sum counts that time twice; the union counts it once."""
    parts = {k: (ms / steps, c / steps) for k, (ms, c) in by_name.items()
             if "int8_" in k}
    mine = [iv for k, ivs in spans.items() if "int8_" in k for iv in ivs]
    return {"int8_dense_device_ms_per_step": sum(v[0] for v in parts.values()),
            "int8_dense_device_ms_per_step_union": _union_ms(mine) / steps,
            "int8_dense_kernels": {k[:90]: {"ms": ms, "calls_per_step": c}
                                   for k, (ms, c) in parts.items()}}


def _top(by_name, steps, n=12):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:90], "ms": ms / steps, "calls_per_step": c / steps}
            for k, (ms, c) in top]


def run(rung, steps, model, prompts):
    gen = Generator(model, max_seq=1024, batch_buckets=(4,),
                    prompt_buckets=(256,), decode_path=rung)
    gen.warmup()
    abba = {}
    for route in (None, "torch", "torch", None):
        name = "kernel" if route is None else "plain"
        abba.setdefault(name, []).extend(
            _decode_walls(gen, prompts, steps, route))
    wall_ms, by_name, spans = _profile(gen, prompts, steps)
    device_ms = sum(ms for ms, _ in by_name.values())
    busy_ms = _union_ms([iv for ivs in spans.values() for iv in ivs])
    return {
        "rung": rung, "steps": steps, "int8_weights": bool(gen._qweights),
        **_int8_split(by_name, steps, spans),
        "decode_step_wall_ms": {k: statistics.median(v)
                                for k, v in abba.items()},
        "profiled_wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": device_ms / steps,
        "device_ms_per_step_union": busy_ms / steps,
        "device_busy_share": device_ms / wall_ms,
        "top_kernels_ms_per_step": _top(by_name, steps),
        "device": torch.cuda.get_device_name(0),
    }


def run_prefill(rung, steps, model, prompts):
    """Host wall (synchronised) and device time by kernel of ``steps``
    prefills of the padded prompts."""
    gen = Generator(model, max_seq=1024, batch_buckets=(4,),
                    prompt_buckets=(256,), decode_path=rung)
    gen.warmup()
    toks, lens, bb = gen._pad_prompts(prompts)

    def prefill():
        gen.prefill(toks, lens, gen._fresh_cache(bb))

    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    spans = {}
    wall_ms, by_name = _kernel_times(prefill, steps, spans)
    device_ms = sum(ms for ms, _ in by_name.values())
    return {
        "rung": rung, "mode": "prefill", "steps": steps,
        "int8_weights": bool(gen._qweights),
        **{k.replace("per_step", "per_prefill"): v
           for k, v in _int8_split(by_name, steps, spans).items()},
        "prefill_wall_ms": walls,
        "profiled_wall_ms_per_prefill": wall_ms / steps,
        "device_ms_per_prefill": device_ms / steps,
        "device_busy_share": device_ms / wall_ms,
        "top_kernels_ms_per_prefill": _top(by_name, steps),
        "device": torch.cuda.get_device_name(0),
    }


def run_speculative(rung, steps, model, prompts, k=4):
    """Device ms of the verify and draft replays of a speculative round,
    and the verify body's device time by kernel (run eagerly)."""
    from .serve import SpeculativeGenerator
    from .serve.generate import _VerifyInputs

    _rng.seed(2)
    draft = get_llama("llama3_8b", device="cuda", num_layers=2)
    sg = SpeculativeGenerator(model, draft, k=k, max_seq=1024,
                              batch_buckets=(4,), prompt_buckets=(256,),
                              decode_path=rung, multistep=True)
    sg.warmup()
    toks, lens, bb = sg.target._pad_prompts(prompts)
    _, cache = sg.target.prefill(toks, lens, sg.target._fresh_cache(bb))
    _, dcache = sg.draft.prefill(toks, lens, sg.draft._fresh_cache(bb))
    blk = np.ones((bb, k + 1), np.int32)
    zeros = np.zeros(bb, np.int32)
    verify_ev, draft_ev = [], []
    for _ in range(steps):
        sg._verify_run(blk, lens, cache, events=verify_ev)
        sg.draft.decode_super(
            zeros, lens, k + 1, np.full(bb, k + 2, np.int32), zeros,
            np.zeros(bb, np.float32), zeros, np.full((bb, 8), -1, np.int32),
            np.zeros(2, np.uint32), dcache, events=draft_ev)
    torch.cuda.synchronize()
    inp = _VerifyInputs(bb, k + 1, 0, torch.device("cuda"))
    inp.fill(tokens=blk, start_pos=lens, last_idx=zeros)
    flat = cache.flat()

    def verify():
        with torch.inference_mode():
            sg._verify_step(*inp.views(), *flat)

    verify()
    spans = {}
    wall_ms, by_name = _kernel_times(verify, steps, spans)
    device_ms = sum(ms for ms, _ in by_name.values())
    out = {
        "rung": rung, "mode": "speculative", "k": k, "steps": steps,
        "verify_replay_device_ms": statistics.median(
            a.elapsed_time(b) for a, b in verify_ev),
        "draft_replay_device_ms": statistics.median(
            a.elapsed_time(b) for a, b in draft_ev),
        "verify_eager_device_ms": device_ms / steps,
        "verify_eager_wall_ms": wall_ms / steps,
        "verify_top_kernels_ms": _top(by_name, steps),
        **{"verify_" + k: v
           for k, v in _int8_split(by_name, steps, spans).items()},
        "device": torch.cuda.get_device_name(0),
    }
    del sg, draft
    return out


def run_multistep(rung, visits, model, prompts):
    """Per-visit device and host times of ``visits`` greedy super-steps
    after one prefill."""
    gen = Generator(model, max_seq=1024, batch_buckets=(4,),
                    prompt_buckets=(256,), decode_path=rung, multistep=True)
    steps = gen.decode_steps
    w = gen.warmup()
    toks, lens, bb = gen._pad_prompts(prompts)
    logits, cache = gen.prefill(toks, lens, gen._fresh_cache(bb))
    ids = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
    pos = lens.copy()
    zeros = np.zeros(bb, np.int32)
    stops = np.full((bb, 8), -1, np.int32)
    walls, events = [], []
    n0 = da.launch_count()
    for _ in range(visits):
        t0 = time.perf_counter()
        block, valid, _, cache = gen.decode_super(
            ids, pos, steps, np.full(bb, 1 << 20, np.int32), zeros,
            np.zeros(bb, np.float32), zeros, stops, np.zeros(2, np.uint32),
            cache, events=events)
        walls.append((time.perf_counter() - t0) * 1e3)
        ids = block[:, -1].copy()
        pos = pos + steps
    device = [a.elapsed_time(b) for a, b in events]
    dev_ms, wall_ms = statistics.median(device), statistics.median(walls)
    launches = (da.launch_count() - n0) / visits
    # two more visits under the profiler: the graph's kernels back to back
    state = {"ids": ids, "pos": pos, "cache": cache}

    def visit():
        block, _, _, state["cache"] = gen.decode_super(
            state["ids"], state["pos"], steps, np.full(bb, 1 << 20, np.int32),
            zeros, np.zeros(bb, np.float32), zeros, stops,
            np.zeros(2, np.uint32), state["cache"])
        state["ids"] = block[:, -1].copy()
        state["pos"] = state["pos"] + steps

    spans = {}
    _, by_name = _kernel_times(visit, 2, spans)
    traced = {k: v for k, v in _int8_split(by_name, 2 * steps, spans).items()
              if k != "int8_dense_kernels"}
    return {
        "rung": rung, "mode": "multistep", "decode_steps": steps,
        "visits": visits, "graphs_captured": w["captures"],
        "capture_s": w["capture_s"],
        "visit_device_ms": dev_ms, "visit_wall_ms": wall_ms,
        "device_ms_per_token_step": dev_ms / steps,
        "wall_ms_per_token_step": wall_ms / steps,
        "device_busy_share": dev_ms / wall_ms,
        "kernel_launches_per_visit": launches,
        **{f"graph_{k}": v for k, v in traced.items()},
        "graph_device_ms_per_step_union": _union_ms(
            [iv for ivs in spans.values() for iv in ivs]) / (2 * steps),
        "device": torch.cuda.get_device_name(0),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rung", choices=("pallas", "int8"), action="append")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--multistep", action="store_true")
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--prefill", action="store_true",
                    help="profile the prefill in place of decode steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA GPU", file=sys.stderr)
        return 2
    cfg = _LLAMA_CONFIGS["llama3_8b"]
    _rng.seed(0)
    model = get_llama("llama3_8b", device="cuda")
    rs = np.random.RandomState(0)
    prompts = [[int(t) for t in rs.randint(1, cfg["vocab_size"], size=n)]
               for n in PROMPT_LENS]
    for rung in args.rung or ("pallas", "int8"):
        if args.prefill:
            print(json.dumps(run_prefill(rung, args.steps, model, prompts)),
                  flush=True)
            torch.cuda.empty_cache()
            continue
        print(json.dumps(run(rung, args.steps, model, prompts)), flush=True)
        torch.cuda.empty_cache()
        if args.multistep:
            print(json.dumps(run_multistep(rung, args.steps, model,
                                           prompts)), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        if args.speculative:
            print(json.dumps(run_speculative(rung, args.steps, model,
                                             prompts)), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
