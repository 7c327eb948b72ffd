"""The sustained-load driver (``python -m mxnet_tpu_torch.serve_load``)
at a test size on the CPU: its traffic is ``bench.py``'s
continuous-batching mix under Poisson arrivals, and a run through the
port's ``ContinuousEngine`` on both rungs, single- and multi-step, serves
every request with no failed check. The timings it prints here are the
CPU's and are not read."""
import json

import numpy as np
import pytest

from mxnet_tpu_torch import serve_load


def test_traffic_is_the_bench_mix_under_poisson_arrivals():
    reqs = serve_load.traffic(4000, rate=2.0, vocab=500, seed=3)
    assert reqs == serve_load.traffic(4000, rate=2.0, vocab=500, seed=3)
    arrivals = np.array([r[0] for r in reqs])
    gaps = np.diff(np.concatenate([[0.0], arrivals]))
    assert (gaps > 0).all()
    # the mean of 4000 exponential gaps: 0.5 s within 5 standard errors
    assert abs(gaps.mean() - 0.5) < 5 * 0.5 / np.sqrt(4000)
    for i, (_, prompt, new, prio) in enumerate(reqs):
        assert all(1 <= t < 500 for t in prompt)
        if i % 4 == 0:
            assert (len(prompt), new, prio) == (8, 48, "batch")
        else:
            assert 4 <= len(prompt) <= 12
            assert (new, prio) == (4, "interactive")
    lens = {len(r[1]) for i, r in enumerate(reqs) if i % 4}
    assert lens == set(range(4, 13))


@pytest.mark.parametrize("mode", ["single", "multi"])
@pytest.mark.parametrize("rung", ["pallas", "int8"])
def test_load_run_serves_every_request_on_the_cpu(rung, mode, capsys,
                                                  monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_METRICS_WINDOW", "2048")
    rc = serve_load.main(["--device", "cpu", "--config", "llama_tiny_test",
                          "--requests", "16", "--rate", "50",
                          "--rung", rung, "--mode", mode])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    assert (out["rung"], out["mode"], out["device"]) == (rung, mode, "cpu")
    assert out["failed"] == [] and out["completed"] == 16
    assert out["tokens"] == 4 * 48 + 12 * 4
    assert out["classes"]["batch"]["ttft_ms"]["n"] == 4
    assert out["classes"]["interactive"]["e2e_ms"]["n"] == 12
    assert out["kernel_launches"] == 0
    iters, visits = out["decode_iterations"], out["decode_visits"]
    assert iters == (8 * visits if mode == "multi" else visits) > 0
    # 16 samples: a median, and p80 leaves 3.2 above it, under ten
    assert set(out["ttft_ms"]) == {"n", "p50"} and out["ttft_ms"]["p50"] > 0
    assert out["e2e_ms"]["p50"] >= out["ttft_ms"]["p50"]
    assert out["itl_ms"]["n"] >= visits and out["itl_ms"]["p50"] > 0


def test_percentiles_leave_ten_samples_above():
    xs = list(range(1, 1001))
    pct = serve_load.percentile
    assert serve_load._pcts(xs) == {"n": 1000, "p50": pct(xs, 50),
                                    "p99": pct(xs, 99)}
    assert set(serve_load._pcts(xs[:200])) == {"n", "p50", "p95"}
    assert set(serve_load._pcts(xs[:100])) == {"n", "p50", "p90"}
    assert set(serve_load._pcts(xs[:50])) == {"n", "p50", "p80"}
