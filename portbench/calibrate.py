#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the program's, the control's and
the faults', over several seeds in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--seconds 40] [--control] [--faults]

Each seed runs the cell as ``run.py`` does (set-up, window, check) and
prints the program's readings.  ``--control`` also reads the control: the
reference computed with float8 e4m3 operands in every linear map, in the
program's place.  For a served cell it reads, at each position of the same
prompts and served tokens, how far the control's first token lies below the
reference's best; for a training cell, the control's three steps against
the reference's.  ``--faults`` (training) reads the reference run on half
of each batch, the mean taken over the rest.  A state left unchanged reads
1 by the measure and needs no run.  One JSON line a seed; the benchmark's
own runs never run this.
"""
import argparse
import json
import sys
import time

import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    R.set_environment()
    from harness import files
    bench = files.load_benchmark()
    cell = files.cell(bench, args.workload)
    cfg_file = files.load_data("configs", cell["config"])
    traffic = files.load_data("traffic", cell["traffic"])
    limits = files.load_data("limits", cell["name"])
    seconds = args.seconds or bench["run_seconds"]
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = {"workload": cell["name"], "seed": seed}
        result, record = R.run_cell(bench, cell, cfg_file, traffic, limits,
                                    seed, seconds, False, "cuda",
                                    time.perf_counter())
        line["program"] = record["check"]
        line["metrics"] = {k: v["value"] for k, v in result["metrics"].items()}
        line.update(control_readings(cfg_file, traffic, seed, record,
                                     args.control, args.faults))
        print(json.dumps(line), flush=True)
        del record
    return 0


def control_readings(cfg_file, traffic, seed, record, control, faults):
    import gc

    import torch

    from harness.check import serve_readings, train_readings
    from harness.train import reference_run
    out = {}
    model_cfg = cfg_file["model"]
    if traffic["driver"] == "train":
        ref = record["reference"]
        runs = {}
        if control:
            runs["control"] = dict(fp8=True)
        if faults:
            runs["half_batch"] = dict(rows=slice(0, traffic["batch"] // 2))
        for name, kw in runs.items():
            got, change = reference_run(model_cfg, traffic, seed, "cuda", **kw)
            got["change"] = change
            out[name] = train_readings(got, ref, ref["change"])
            del got
            gc.collect()
            torch.cuda.empty_cache()
    elif control:
        out["control"] = serve_readings(model_cfg, seed, record["sample"],
                                        traffic["slots"], "cuda", fp8=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
