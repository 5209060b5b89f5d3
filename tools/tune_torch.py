#!/usr/bin/env python
"""Merge, export and refit the PyTorch port's tuning caches.

    python tools/tune_torch.py merge OUT CACHE [CACHE ...]
    python tools/tune_torch.py export CACHE OUT [--machine PREFIX]
    python tools/tune_torch.py refit CACHE [CACHE ...] -o MODEL
        [--base h100_sxm] [--machine PREFIX] [--mode any|cuda|cpu]

``merge`` unions caches (on a shared key the newest timing wins) and
``export`` keeps the entries whose machine tuning key starts with PREFIX
(``h100_sxm`` keeps ``h100_sxm`` and ``h100_sxm+net``; the full ``+net``
form keeps only network-calibrated records).

The port's counterpart of ``tools/tune.py refit`` (which fits the JAX
package's model): the caches are merged as ``tools/tune.py merge`` merges
them (newest timing wins), their timings are regressed onto the base
model's dispatch coefficients by ``repro_torch.core.refit``, and the
versioned refit-model JSON is written to MODEL, for ``--refit-model`` of
``python -m repro_torch.launch.serve`` or ``load_refit_model``.  The port's
tuning caches are the reference's file format, so ``tools/tune.py show``,
``merge`` and ``export`` read them as they are.
"""
from __future__ import annotations

import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
from tune import (filter_entries, load_entries, merge_entries,  # noqa: E402
                  write_cache)


def _cmd_merge(args) -> int:
    caches = [load_entries(p) for p in args.inputs]
    merged = merge_entries(caches)
    write_cache(args.out, merged)
    print(f"merged {len(args.inputs)} files "
          f"({sum(len(c) for c in caches)} entries) -> {args.out} "
          f"({len(merged)} entries)", file=sys.stderr)
    return 0


def _cmd_export(args) -> int:
    entries = load_entries(args.cache)
    kept = filter_entries(entries, args.machine) if args.machine else entries
    write_cache(args.out, kept)
    print(f"exported {len(kept)}/{len(entries)} entries -> {args.out}",
          file=sys.stderr)
    return 0


def _cmd_refit(args) -> int:
    sys.path.insert(0, os.path.join(_HERE, os.pardir, "src"))
    from repro_torch.core import refit
    from repro_torch.core.machine import get_machine
    merged = merge_entries([load_entries(p) for p in args.inputs])
    try:
        model = refit.fit_cache_entries(
            merged, get_machine(args.base), machine=args.machine or None,
            mode=None if args.mode == "any" else args.mode)
    except ValueError as e:
        print(f"refit failed: {e}", file=sys.stderr)
        return 1
    refit.save_refit_model(args.out, model)
    res = model["residual_us"]
    print(f"refit {model['entries']} entries (skipped {model['skipped']}) "
          f"-> {args.out}\n  fingerprint={model['fingerprint']} fitted="
          f"{','.join(model['fitted'])}\n  residual_us before="
          f"{res['before']} after={res['after']}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("merge", help="union caches, newest timing wins")
    p.add_argument("out")
    p.add_argument("inputs", nargs="+")
    p.set_defaults(fn=_cmd_merge)
    p = sub.add_parser("export", help="filter a cache to one machine")
    p.add_argument("cache")
    p.add_argument("out")
    p.add_argument("--machine", default=None,
                   help="machine tuning-key prefix to keep")
    p.set_defaults(fn=_cmd_export)
    p = sub.add_parser(
        "refit", help="fit MachineModel coefficients from cache timings")
    p.add_argument("inputs", nargs="+",
                   help="tuning-cache files (merged before fitting)")
    p.add_argument("-o", "--out", required=True,
                   help="refit-model JSON to write")
    p.add_argument("--machine", default=None,
                   help="keep entries whose tuning key starts with this")
    p.add_argument("--mode", default="any", choices=("any", "cuda", "cpu"),
                   help="keep entries timed on one device type")
    p.add_argument("--base", default="h100_sxm",
                   help="base machine model to refit (h100_sxm or tpu_v5e)")
    p.set_defaults(fn=_cmd_refit)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
