"""Time the strict rung's decode from several checkouts in turns on one card.

    python -m mxnet_tpu_torch.strict_decode_ab ROOT [ROOT ...]

Each ROOT is a checkout of this repository (``.`` is this one). To compare
a change with its parent on one card, unpack the parent (``git archive``)
into a directory that ``.gitignore`` lists and give ``PARENT . . PARENT``.

For each ROOT in turn, one process imports ``mxnet_tpu_torch`` from ROOT,
builds its kernels and ``llama3_8b`` with random weights from seed 0, and
serves ``chip_smoke.py``'s 4 prompts (17, 64, 130 and 250 tokens from seed
0) for 32 greedy tokens in a 1024-position ring on the strict
``baseline`` rung: a single-step ``Generator`` and a multi-step one (8
decode iterations a visit, on CUDA graphs), each after its warmup and one
untimed generate, then ``--reps`` timed generates. The child runs this
file's :func:`measure` by path, so ROOT's package needs nothing of it.

Prints the card's name and power limit first, then one JSON line a process
(``root``, decode ms a token of each generate for both generators: the
decode loop's host wall time over its steps as ``Generator.generate``
reports it, prefill ms, and a hash of the tokens), and last one line a
ROOT with the medians. Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

PROMPT_LENS = (17, 64, 130, 250)
NEW_TOKENS = 32
DECODE_STEPS = 8
MAX_SEQ = 1024


def measure(root, reps):
    """One ROOT's readings (runs in a child process whose ``sys.path``
    starts at ROOT)."""
    import hashlib

    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import get_llama
    from mxnet_tpu_torch.models.llama import _LLAMA_CONFIGS
    from mxnet_tpu_torch.serve import Generator

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    vocab = _LLAMA_CONFIGS["llama3_8b"]["vocab_size"]
    mt.random.seed(0)
    model = get_llama("llama3_8b", device=dev)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, vocab, size=n)]
               for n in PROMPT_LENS]
    kw = dict(max_seq=MAX_SEQ, batch_buckets=(1, 4),
              prompt_buckets=(64, 256), decode_path="baseline")
    result = {"root": root, "package": os.path.dirname(mt.__file__)}
    for label, extra in (("single_step", {}),
                         ("multi_step", dict(multistep=True,
                                             decode_steps=DECODE_STEPS))):
        gen = Generator(model, name=f"ab_{label}", **kw, **extra)
        gen.warmup()
        out, _ = gen.generate(prompts, max_new_tokens=NEW_TOKENS)
        ms, pre = [], []
        for _ in range(reps):
            again, info = gen.generate(prompts, max_new_tokens=NEW_TOKENS)
            if again != out:
                raise RuntimeError(f"{label}: a timed generate's tokens "
                                   "differ from the first's")
            ms.append(info["decode_ms"] / info["decode_steps"])
            pre.append(info["prefill_ms"])
        result[label] = {
            "decode_ms_per_token": ms, "prefill_ms": pre,
            "tokens_sha1": hashlib.sha1(
                json.dumps(out).encode()).hexdigest()[:12]}
        del gen
        torch.cuda.empty_cache()
    return result


def _nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(measure(args.roots[0], args.reps)), flush=True)
        return 0
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    here = os.path.abspath(__file__)
    code = ("import runpy, sys; "
            f"sys.exit(runpy.run_path({here!r})['main'](sys.argv[1:]))")
    by_root = {}
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, "-c", code, "--child", "--reps",
             str(args.reps), os.path.abspath(root)], capture_output=True,
            text=True, cwd=os.path.abspath(root))
        if proc.returncode:
            print(proc.stdout[-2000:] + proc.stderr[-4000:], flush=True)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        got = json.loads(line)
        got["root"] = root
        print(json.dumps(got), flush=True)
        for label in ("single_step", "multi_step"):
            by_root.setdefault(root, {}).setdefault(label, []).extend(
                got[label]["decode_ms_per_token"])
    for root, labels in by_root.items():
        print(json.dumps({"root": root, **{
            f"{label}_median_ms_per_token": statistics.median(v)
            for label, v in labels.items()}}), flush=True)
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
