#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  It measures ``repro_torch`` (``src/repro_torch``) and nothing else:
set-up (kernel build or load, weights drawn on the card from the seed,
warm-up of every shape the cell's traffic uses), then a window of
``--seconds``, then the check of what the timed path produced against the
plain reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` (and with
``--trace 1`` ``breakdown``), then ``check``, each compared number beside
its limit; the same numbers are the last lines of standard error.

Every cache of the program stays inside the checkout, under
``build/portbench/``.  A machine without enough CUDA devices, a checkout
without the program, or a process that loaded JAX or the JAX package exits
non-zero and prints no result.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The program's knobs, left to their defaults whatever the environment says.
PROGRAM_KNOBS = ("REPRO_AUTOTUNE", "REPRO_AUTOTUNE_BUDGET", "REPRO_FUSED",
                 "REPRO_QUANT", "REPRO_TUNING_CACHE",
                 "REPRO_TUNING_CACHE_PRELOAD", "REPRO_WARM_START")


def set_environment() -> None:
    cache = ROOT / "build" / "portbench"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for knob in PROGRAM_KNOBS:
        os.environ.pop(knob, None)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(bench, cell, cfg_file, traffic, limits, seed, seconds, trace,
             device, t_proc):
    """Set-up, window and check of one cell; returns (result, record)."""
    from harness import files, serve, train
    from harness.check import judge
    from harness.trace import Tracer, breakdown
    driver = {"open_loop": serve.run, "saturated": serve.run,
              "train": train.run}[traffic["driver"]]
    tracer = Tracer()
    record = driver(cfg_file, traffic, seed, seconds, trace, device, t_proc,
                    tracer)
    record.update(cell=cell["name"], cfg=cfg_file["model"], traffic=traffic,
                  seconds=seconds, trace=trace)
    metrics = {}
    for m in files.metrics_for(bench, cell["name"], trace):
        value = files.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    verdict = judge(record["check"], limits)
    result = {"correct": verdict["correct"], "attempted": record["attempted"],
              "failed": 0, "metrics": metrics}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": _device_name(device), "count": cell["chips"],
           "memory_peak_bytes": record["memory_peak_bytes"]}
    prof = record.get("profile")
    if trace and prof is not None:
        dev["busy_s"] = sum(b - a for a, b in prof["busy"])
        dev["window_s"] = prof["window"][1] - prof["window"][0]
        result["breakdown"] = breakdown(prof)
    result["device"] = dev
    result["check"] = verdict["numbers"]
    return result, record


def _device_name(device):
    if device == "cuda":
        import torch
        return torch.cuda.get_device_name(0)
    return device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(BENCH))
    from harness import files
    bench = files.load_benchmark()
    cell = files.cell(bench, args.workload)
    cfg_file = files.load_data("configs", cell["config"])
    traffic = files.load_data("traffic", cell["traffic"])
    limits = files.load_data("limits", cell["name"])
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    card = power_limit()
    result, _ = run_cell(bench, cell, cfg_file, traffic, limits,
                         args.seed, args.seconds, bool(args.trace), "cuda",
                         T_PROC)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}; the benchmark "
              f"measures repro_torch alone", file=sys.stderr)
        return 4
    result["device"]["card"] = card
    for name, num in result["check"].items():
        print(f"check {name}: {num['value']} (limit {num['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
