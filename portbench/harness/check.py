"""The comparison that decides ``correct``: the program's outputs from the
timed path against the plain reference, each number beside its limit
(``portbench/limits/<cell>.json``)."""
from __future__ import annotations

import statistics
from typing import Callable, Dict, List

from harness import weights as W


def weight_source(cfg: Dict, seed: int, device) -> Callable:
    """``get(names) -> {name: float32 leaf}``, each drawn again from the
    seed."""
    leaves = {leaf[0]: leaf for leaf in W.all_leaves(cfg)}
    return lambda names: {n: W.draw(seed, leaves[n], device) for n in names}


def serve_readings(cfg: Dict, seed: int, samples: List[Dict],
                   decode_call_tokens: int, device, fp8: bool = False
                   ) -> Dict:
    """Served requests against the reference: for each served token, how
    far its reference logit lies below the reference's best.  ``samples``:
    {"prompt": int array, "served": [int]}.  With ``fp8`` the control's
    first token at each position is read instead of the served one."""
    import torch

    from reference.model import logit_gaps, served_logits
    seqs, lens, served = [], [], []
    for s in samples:
        ctx = list(s["prompt"]) + list(s["served"][:-1])
        seqs.append(torch.tensor(ctx, dtype=torch.long, device=device))
        lens.append(len(s["prompt"]))
        served.append(torch.tensor(s["served"], dtype=torch.long,
                                   device=device))
    get = weight_source(cfg, seed, device)
    ref = served_logits(cfg, get, seqs, lens, decode_call_tokens)
    ctrl = served_logits(cfg, get, seqs, lens, decode_call_tokens,
                         fp8=True) if fp8 else [None] * len(ref)
    gaps = [logit_gaps(r, t, c) for r, t, c in zip(ref, served, ctrl)]
    every = torch.cat(gaps)
    widest = sorted(((float(g[j]), i, j) for i, g in enumerate(gaps)
                     for j in torch.topk(g, min(3, g.numel())).indices
                     .tolist()), reverse=True)[:5]
    return {"max_logit_gap": float(every.max()),
            "mean_logit_gap": float(every.mean()),
            "share_off_best": float((every > 0).float().mean()),
            "tokens_compared": int(every.numel()),
            "widest": [[round(g, 4), i, j] for g, i, j in widest]}


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                names) -> float:
    """Largest |prog - ref| a leaf, over the larger of the leaf's reference
    norm and the median leaf's."""
    median = statistics.median(ref[n] for n in ref)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


def train_readings(prog: Dict, ref: Dict, ref_change: Dict[str, float]
                   ) -> Dict:
    """``prog``: the program's step losses, first clipped gradient norm and
    parameter change norm a leaf; ``ref``: the reference's run and
    ``ref_change`` its change norms.  Leaves whose reference gradient is
    under a thousandth of the median leaf's move by round-off alone and
    are left out of the change."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"])]
    g_ref = ref["first_grad"]
    median = statistics.median(g_ref.values())
    moving = [n for n in g_ref if g_ref[n] >= 1e-3 * median]
    return {"loss_gap": max(losses),
            "grad_gap": _worst_leaf(prog["first_grad"], g_ref, list(g_ref)),
            "change_gap": _worst_leaf(prog["change"], ref_change, moving),
            "leaves_left_out": len(g_ref) - len(moving)}


def judge(readings: Dict, limits: Dict) -> Dict:
    """{name: {"value", "limit"}} for every limited number, and whether all
    are within their limits.  A number with no limit on file fails."""
    out, ok = {}, True
    for name, limit in limits.get("limits", {}).items():
        value = readings.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and limit is not None and value <= limit
    return {"correct": bool(ok and out), "numbers": out}
