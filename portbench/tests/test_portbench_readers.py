"""Tails and rates from every sample of the window, on a synthetic
timeline that holds a stall."""
import numpy as np
import pytest

from harness import files, readers

CFG = files.load_data("configs", "phi3.5-moe-42b.pp4")["model"]


def timeline():
    """Window [10, 20].  A request is due every second from t = 8; each is
    admitted at the start of the next step and emits a token every 0.1 s
    for 1.5 s.  The server stalls over [14, 17]: nothing is emitted, and the
    requests due then wait until 17."""
    steps, requests = [], []
    t = 8.0
    while t < 25.0:
        if 14.0 <= t < 17.0:
            t = 17.0
        steps.append({"t0": t, "t1": t + 0.1, "active": 1, "admitted": []})
        t += 0.1
    for rid, due in enumerate(np.arange(8.0, 21.0, 1.0)):
        start = next(i for i, s in enumerate(steps) if s["t0"] >= due)
        steps[start]["admitted"].append(100)
        times = [steps[start + j]["t1"] for j in range(15)]
        requests.append({"rid": rid, "due": float(due), "prompt_len": 100,
                         "max_new": 15, "times": times,
                         "admitted_step": start})
    return {"window": [10.0, 20.0], "clean_end": 20.0, "steps": steps,
            "requests": requests, "cfg": CFG}


def test_rate_counts_every_token_of_the_window():
    rec = timeline()
    want = sum(1 for r in rec["requests"] for t in r["times"]
               if 10.0 <= t <= 20.0)
    assert readers.output_tokens_per_s(rec) == pytest.approx(want / 10.0)


def test_ttft_counts_the_stall_from_the_due_time():
    rec = timeline()
    ttft = readers.ttft_s(rec, 10.0, 20.0)
    assert len(ttft) == 10                     # due at 10, 11, ..., 19
    # due at 14, 15, 16 wait for the stall to end at 17
    assert max(ttft) == pytest.approx(17.1 - 14.0)
    assert sorted(ttft)[:3] == pytest.approx([0.1, 0.1, 0.1])


def test_ttft_censors_a_request_still_waiting():
    rec = timeline()
    rec["requests"].append({"rid": 99, "due": 19.5, "prompt_len": 100,
                            "max_new": 10, "times": [],
                            "admitted_step": None})
    assert max(readers.ttft_s(rec, 10.0, 20.0)) == pytest.approx(3.1)
    assert min(readers.ttft_s(rec, 10.0, 20.0)) == pytest.approx(0.1)
    assert 0.5 in [pytest.approx(x) for x in readers.ttft_s(rec, 10.0, 20.0)]


def test_itl_holds_the_stall_gap():
    rec = timeline()
    gaps = readers.itl_s(rec, 10.0, 20.0)
    # a request due before the stall emits at its start, then at 17.1
    assert 2.9 < max(gaps) < 3.2
    assert min(gaps) == pytest.approx(0.1)
    p = readers.percentile(gaps, 95)
    assert p == pytest.approx(float(np.percentile(gaps, 95)))


def test_queue_wait_censors_at_the_window_end():
    rec = timeline()
    waits = readers.queue_wait_s(rec)
    assert len(waits) == 10
    assert max(waits) == pytest.approx(3.0)    # due 14, admitted at 17
    rec["requests"].append({"rid": 99, "due": 19.0, "prompt_len": 100,
                            "max_new": 10, "times": [],
                            "admitted_step": None})
    assert readers.queue_wait_s(rec)[-1] == pytest.approx(1.0)


def test_percentile_of_nothing_is_nothing():
    assert readers.percentile([], 90) is None


def test_train_rate_spans_whole_steps():
    rec = {"step_ends": [1.3, 2.6, 3.9, 5.2], "tokens_per_step": 32768}
    assert readers.train_tokens_per_s(rec) == pytest.approx(
        4 * 32768 / 5.2)


def test_expert_roofline_reads_decode_steps_alone():
    """Three profiled steps: two decode steps and one that also admits a
    prompt.  The grouped kernels launched inside the admitting step, and
    kernels of other families, are not read."""
    from harness import roofline
    steps = [{"t0": 0.0, "t1": 1.0, "active": 64, "admitted": [],
              "traced": False},
             {"t0": 1.0, "t1": 2.0, "active": 64, "admitted": [],
              "traced": True},
             {"t0": 2.0, "t1": 3.0, "active": 64, "admitted": [997],
              "traced": True},
             {"t0": 3.0, "t1": 4.0, "active": 60, "admitted": [],
              "traced": True}]
    kernels, launches = [], {}
    for i, (name, launch, dur) in enumerate([
            ("grouped_fused<1>", 10.1, 0.004),
            ("gemm_bf16_kernel", 10.2, 0.001),
            ("grouped_fused<1>", 11.1, 0.900),       # the prefill's
            ("grouped_fused<1>", 12.1, 0.006)]):
        kernels.append((name, launch + 0.01, dur, i))
        launches[i] = launch
    prof = {"window": (10.0, 13.0), "kernels": kernels, "launches": launches,
            "spans": [("step", 10.0, 11.0), ("step", 11.0, 12.0),
                      ("step", 12.0, 13.0)], "busy": [(10.0, 10.5)]}
    rec = {"cfg": CFG, "steps": steps, "profile": prof}
    bound = roofline.expert_bound_s(CFG, 64) + roofline.expert_bound_s(CFG, 60)
    assert readers.expert_roofline(rec) == pytest.approx(
        100 * bound / 0.010)
    rec["steps"] = steps[:3]
    with pytest.raises(RuntimeError):
        readers.expert_roofline(rec)
