"""Finding a cell's files by the names in ``BENCHMARK.json``."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_data(kind: str, name: str) -> Dict:
    """``portbench/<kind>/<name>.json``: a configuration, a traffic mix or a
    cell's limits."""
    return json.loads((BENCH_DIR / kind / f"{name}.json").read_text())


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def _applies(metric: Dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def metrics_for(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones.
    A per-layer metric without ``workloads`` applies wherever the metric it
    moves is reported."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell_name)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if m["moves"] in names and _applies(m, cell_name)]


def reader(metric_name: str) -> Callable[[Dict], object]:
    """``read(record)`` of ``portbench/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric_name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
