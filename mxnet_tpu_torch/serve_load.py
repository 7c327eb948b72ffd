"""Server metrics under sustained load: Llama-3-8B served by
``ContinuousEngine`` on one GPU, fed by an open-loop arrival process.

    python -m mxnet_tpu_torch.serve_load [--rung pallas|int8] [--mode
        single|multi] [--requests 240] [--rate 2.0] [--seed 0]

Traffic is ``bench.py``'s continuous-batching mix
(``bench_llama_continuous_batching``), repeated: in every four requests
one batch-class request (an 8-token prompt for 48 new tokens) and three
interactive ones (prompts of 4-12 tokens for 4 new tokens), greedy, with
prompt tokens drawn from the vocabulary. Arrivals are Poisson at
``--rate`` requests a second (seeded exponential gaps); one client thread
submits each request at its arrival time whatever the engine's state
(open loop) and records how late it was.

The engine is ``chip_smoke.py`` phase 5c's: ``max_seq=1024``, 4 slots,
pages of ``natural_block()`` positions, ``(1, 256)`` prefill chunks, the
prefix cache on, single-step or multi-step (``decode_steps=8``, CUDA
graphs captured by ``warmup()``). Weights are random (seed 0).

For each rung and mode one JSON line: TTFT and end-to-end latency over
all requests and by class, each timed from when the request was due (the
engine's enqueue-to-first-token plus how late the client submitted it;
the end to end on the client's clock), ITL (every decode iteration's
share of its visit's token-to-token gap), tokens/s and requests/s over
the window from the schedule's start to the last result,
queue depth and live slots as each request arrived, decode visits and
iterations, host visits a token, peak memory. A timing gives its sample
count, its median and the highest of p99, p95, p90 and p80 that leaves
at least ten samples above it. The metrics ring is sized to hold every
sample of the run. A run fails (exit 1) unless every
request returns its tokens, the decode-attention kernel launches once a
layer for every decode iteration (counted at graph replay), no shape or
graph is new after ``warmup()`` and every page is free at the end.

``--device cpu --config llama_tiny_test`` runs the same at a test size.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from . import random as _rng
from .models import get_llama
from .models.llama import _LLAMA_CONFIGS
from .ops.hopper import decode_attention as da
from .serve import ContinuousEngine, percentile

# bench.py's continuous-batching mix: (prompt tokens, new tokens, class)
LONG = ((8, 8), 48, "batch")
SHORT = ((4, 12), 4, "interactive")
ENGINE = dict(max_seq=1024, num_slots=4, prefill_chunk=256,
              prefix_cache=True, decode_steps=8)
WAIT = 900  # seconds the last request may take after its arrival


def traffic(n, rate, vocab, seed=0):
    """``n`` requests as ``(arrival_s, prompt, max_new, priority)``: every
    fourth one long, the rest short; Poisson arrivals at ``rate``/s."""
    rng = np.random.RandomState(seed)
    out, t = [], 0.0
    for i in range(n):
        (lo, hi), new, prio = LONG if i % 4 == 0 else SHORT
        prompt = rng.randint(1, vocab, size=int(rng.randint(lo, hi + 1)))
        t += float(rng.exponential(1.0 / rate))
        out.append((t, [int(x) for x in prompt], new, prio))
    return out


def _pcts(xs):
    """Sample count, median, and the highest percentile of (99, 95, 90,
    80) with at least ten samples above it."""
    out = {"n": len(xs), "p50": percentile(xs, 50)}
    top = next((p for p in (99, 95, 90, 80) if len(xs) * (100 - p) >= 1000),
               None)
    if top is not None:
        out[f"p{top}"] = percentile(xs, top)
    return out


def run(model, rung, multistep, reqs, n_layers, **engine_kw):
    """Serve ``reqs`` through a fresh engine; returns the readings and a
    list of failed checks (empty when every check held)."""
    kw = dict(ENGINE, **engine_kw)
    cuda = next(model.parameters()).is_cuda
    if cuda:
        kw.setdefault("page_size", da.natural_block())
        torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(model, decode_path=rung, multistep=multistep,
                           max_queue=len(reqs), name=f"load_{rung}", **kw)
    failed = []
    done, lock = {}, threading.Lock()

    def stamp(i):
        def cb(_f):
            with lock:
                done[i] = time.perf_counter()
        return cb

    try:
        w = eng.warmup()
        captures = eng._msession.captures if multistep else 0
        eng.start()
        st0, n0 = eng.stats(), da.launch_count()
        late, queue, live, futs = [], [], [], []
        t0 = time.perf_counter()
        for i, (t_arr, prompt, new, prio) in enumerate(reqs):
            delay = t0 + t_arr - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            late.append(max(0.0, -delay) * 1e3)
            queue.append(eng.metrics.queue_depth)
            live.append(eng.metrics.slots_live)
            f = eng.submit(prompt, max_new_tokens=new, priority=prio)
            f.add_done_callback(stamp(i))
            futs.append(f)
        res = []
        for f in futs:
            try:
                res.append(f.result(timeout=WAIT))
            except Exception as e:  # noqa: BLE001 -- counted as a failure
                res.append(None)
                failed.append(f"request failed: {type(e).__name__}: {e}")
        wall = time.perf_counter() - t0
        st = eng.stats()
        launches = da.launch_count() - n0
        itl = [ms for ms, _ in eng.metrics.itl_samples()]
        eng.assert_no_recompiles()
        if multistep and eng._msession.captures != captures:
            failed.append("a graph was captured after warmup")
    finally:
        eng.close()
    if eng.prefix is not None:
        eng.prefix.clear()
    pool = eng.stats()["pool"]
    if pool["pages_owned"] or pool["pages_used"]:
        failed.append(f"pages not recycled: {pool}")
    ok = [(r, q) for r, q in zip(res, reqs) if r is not None]
    failed += [f"request {i} returned {len(r['tokens'])} of {q[2]} tokens"
               for i, (r, q) in enumerate(ok) if len(r["tokens"]) != q[2]]
    iters = st["decode_iterations"] - st0["decode_iterations"]
    visits = st["decode_visits"] - st0["decode_visits"]
    want = n_layers * iters if cuda else 0
    if launches != want:
        failed.append(f"{launches} kernel launches for {iters} decode "
                      f"iterations x {n_layers} layers")
    tokens = sum(len(r["tokens"]) for r, _ in ok)
    decoded = sum(r["decode_steps"] for r, _ in ok)
    # the scheduler thread, joined by close(), ran every done callback
    served = [i for i, r in enumerate(res) if r is not None]
    ttft = {i: res[i]["ttft_ms"] + late[i] for i in served}
    e2e = {i: (done[i] - t0 - reqs[i][0]) * 1e3 for i in served}
    by_class = {}
    for prio in (LONG[2], SHORT[2]):
        idx = [i for i in served if reqs[i][3] == prio]
        by_class[prio] = {"ttft_ms": _pcts([ttft[i] for i in idx]),
                          "e2e_ms": _pcts([e2e[i] for i in idx])}
    return {
        "rung": rung, "mode": "multi" if multistep else "single",
        "requests": len(reqs), "completed": len(ok),
        "offered_rate_req_s": len(reqs) / reqs[-1][0],
        "achieved_rate_req_s": len(ok) / wall,
        "window_s": wall, "tokens": tokens, "tokens_s": tokens / wall,
        "ttft_ms": _pcts(list(ttft.values())),
        "e2e_ms": _pcts(list(e2e.values())), "classes": by_class,
        "itl_ms": _pcts(itl), "itl_mean_ms": sum(itl) / max(len(itl), 1),
        "itl_samples": len(itl),
        "decode_visits": visits, "decode_iterations": iters,
        "host_visits_per_token": visits / max(decoded, 1),
        "kernel_launches": launches,
        "queue_depth_at_arrival": {"mean": float(np.mean(queue)),
                                   "max": int(max(queue))},
        "slots_live_at_arrival": float(np.mean(live)),
        "client_late_ms": {"mean": float(np.mean(late)), "max": max(late)},
        "warmup_s": w["wall_s"], "graphs_captured": captures,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated() if cuda
                           else None),
    }, failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rung", choices=("pallas", "int8"), action="append")
    ap.add_argument("--mode", choices=("single", "multi"), action="append")
    ap.add_argument("--requests", type=int, default=240)
    ap.add_argument("--rate", type=float, default=2.0,
                    help="Poisson arrivals a second")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", default="llama3_8b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("serve_load: needs a CUDA GPU (or --device cpu)",
              file=sys.stderr)
        return 2
    # every ITL and TTFT sample of the run stays in the metrics ring
    os.environ["MXNET_SERVE_METRICS_WINDOW"] = str(1 << 20)
    cfg = _LLAMA_CONFIGS[args.config]
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    _rng.seed(0)
    model = get_llama(args.config, device=args.device)
    reqs = traffic(args.requests, args.rate, cfg["vocab_size"], args.seed)
    engine_kw = {} if args.device == "cuda" else dict(
        max_seq=64, page_size=16, prefill_chunk=16)
    bad = []
    for rung in args.rung or ("pallas", "int8"):
        for mode in args.mode or ("single", "multi"):
            out, failed = run(model, rung, mode == "multi", reqs,
                              cfg["num_layers"], **engine_kw)
            out.update(config=args.config, seed=args.seed,
                       device=(torch.cuda.get_device_name(0)
                               if args.device == "cuda" else "cpu"),
                       failed=failed)
            print(json.dumps(out), flush=True)
            bad += failed
            gc.collect()
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
