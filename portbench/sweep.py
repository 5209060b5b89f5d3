#!/usr/bin/env python3
"""The knee of an open-loop cell: the highest arrival rate the port
sustains without a growing queue.

    python3 portbench/sweep.py --workload <name> --seed <n> \
        --rates 2,3,4,5 [--seconds 30] [--slots 64]

One set-up (the prompt lengths of the largest rate's schedule warmed), then
for each rate the cell's open loop (its ramp, then ``--seconds``), then a
drain.  One JSON line a rate: the offered and the served rates, time to
first token, the queue wait in the window's first and second halves, and
the requests due in the window that no slot had admitted at its end.  The
knee is written into the traffic file by hand; the benchmark's runs never
run this.
"""
import argparse
import json
import sys
import time

import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--slots", type=int, default=None)
    args = ap.parse_args(argv)
    R.set_environment()
    import torch

    from harness import files, port, readers, serve
    from harness.trace import Tracer
    from harness.traffic import schedule
    bench = files.load_benchmark()
    cell = files.cell(bench, args.workload)
    cfg_file = files.load_data("configs", cell["config"])
    traffic = files.load_data("traffic", cell["traffic"])
    if args.slots:
        traffic["slots"] = args.slots
    rates = [float(r) for r in args.rates.split(",")]
    vocab = cfg_file["model"]["vocab_size"]

    def plan_at(rate):
        return schedule(dict(traffic, rate_per_s=rate), args.seconds,
                        args.seed, vocab)

    cfg = port.port_config(cfg_file)
    with port.defaults("cuda"):
        t0 = time.perf_counter()
        eng = serve.setup(cfg, cfg_file, traffic, args.seed, "cuda",
                          [len(p.prompt) for p in plan_at(max(rates))])
        torch.cuda.synchronize()
        print(json.dumps({"setup_s": time.perf_counter() - t0,
                          "slots": traffic["slots"]}), flush=True)
        for rate in rates:
            record, _ = serve.loop(eng, plan_at(rate),
                                   dict(traffic, rate_per_s=rate),
                                   args.seconds, False, Tracer())
            record["cfg"] = cfg_file["model"]
            w0, w1 = record["window"]
            mid = (w0 + w1) / 2
            waits = readers.queue_wait_s(record)
            due = [r for r in record["requests"] if w0 <= r["due"] < w1]
            half = [[wt for wt, r in zip(waits, due) if r["due"] < mid],
                    [wt for wt, r in zip(waits, due) if r["due"] >= mid]]
            line = {
                "rate_per_s": rate, "due_in_window": len(due),
                "output_tokens_per_s": readers.output_tokens_per_s(record),
                "ttft_p50_s": readers.percentile(
                    readers.ttft_s(record, w0, w1), 50),
                "ttft_p90_s": readers.percentile(
                    readers.ttft_s(record, w0, w1), 90),
                "itl_p95_s": readers.percentile(
                    readers.itl_s(record, w0, w1), 95),
                "queue_wait_p90_s_halves": [readers.percentile(h, 90)
                                            for h in half],
                "not_admitted_at_end": sum(
                    1 for r in due if r["admitted_step"] is None),
                "mean_active": sum(s["active"] for s in record["steps"])
                / max(1, len(record["steps"])),
                "decode_step_ms": readers.decode_step_ms(record)}
            print(json.dumps(line), flush=True)
            t_drain = time.perf_counter()
            while eng.step():
                pass
            print(json.dumps({"drained_s": time.perf_counter() - t_drain}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
