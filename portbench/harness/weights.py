"""The benchmark's weights, drawn on the device from ``--seed``.

Each leaf has a generator of its own, seeded from the run's seed and the
leaf's name, so a leaf can be drawn again alone: the program gets every leaf
at set-up, and the reference draws each layer's leaves again when it reaches
that layer, after the program's state is freed.  The leaves are named and
shaped as the port's ``LanguageModel`` names them (``named_parameters``);
the harness refuses a model whose parameters differ.  Distributions: linear
maps N(0, 1) / sqrt(fan_in), the embedding N(0, 0.02^2), norm scales
1 + N(0, 0.1^2) (not all ones, so a norm wired wrong shows).  fp32, the
dtype of the port's master weights.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

Leaf = Tuple[str, Tuple[int, ...], str, int]   # name, shape, kind, fan_in


def layer_leaves(cfg: Dict, i: int) -> List[Leaf]:
    d, hq, hkv, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                      cfg["head_dim"])
    f, e = cfg["d_ff"], cfg["num_experts"]
    p = f"blocks.{i}."
    out = [(p + "norm_mix.scale", (d,), "norm", 0),
           (p + "mixer.wq.w", (d, hq * hd), "linear", d),
           (p + "mixer.wk.w", (d, hkv * hd), "linear", d),
           (p + "mixer.wv.w", (d, hkv * hd), "linear", d),
           (p + "mixer.wo.w", (hq * hd, d), "linear", hq * hd),
           (p + "norm_ff.scale", (d,), "norm", 0)]
    if e:
        out += [(p + "ff.router.w", (d, e), "linear", d),
                (p + "ff.w_gate.w", (e, d, f), "linear", d),
                (p + "ff.w_up.w", (e, d, f), "linear", d),
                (p + "ff.w_down.w", (e, f, d), "linear", f)]
    else:
        out += [(p + "ff.w_gate.w", (d, f), "linear", d),
                (p + "ff.w_up.w", (d, f), "linear", d),
                (p + "ff.w_down.w", (f, d), "linear", f)]
    return out


def outer_leaves(cfg: Dict) -> List[Leaf]:
    d, v = cfg["d_model"], cfg["vocab_size"]
    return [("embed.table", (v, d), "embed", 0),
            ("final_norm.scale", (d,), "norm", 0),
            ("lm_head.w", (d, v), "linear", d)]


def all_leaves(cfg: Dict) -> List[Leaf]:
    out = outer_leaves(cfg)[:1]
    for i in range(cfg["num_layers"]):
        out += layer_leaves(cfg, i)
    return out + outer_leaves(cfg)[1:]


def leaf_seed(seed: int, name: str) -> int:
    return (int(seed) * 0x9E3779B1 + zlib.crc32(name.encode())) % (1 << 63)


def draw(seed: int, leaf: Leaf, device):
    import torch
    name, shape, kind, fan_in = leaf
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    if kind == "linear":
        return x.mul_(fan_in ** -0.5)
    if kind == "embed":
        return x.mul_(0.02)
    return x.mul_(0.1).add_(1.0)


def load_into(model, cfg: Dict, seed: int) -> None:
    """Overwrite every parameter of the port's ``model`` with the
    benchmark's draw; refuse a model whose parameters are not the leaves
    above, by name and shape."""
    import torch
    want = {name: shape for name, shape, _, _ in all_leaves(cfg)}
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if want != have:
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        wrong = sorted(n for n in set(want) & set(have) if want[n] != have[n])
        raise RuntimeError(f"the program's parameters differ from the "
                           f"benchmark's leaves: missing {missing[:5]}, extra "
                           f"{extra[:5]}, other shapes {wrong[:5]}")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for leaf in all_leaves(cfg):
            p = params[leaf[0]]
            p.copy_(draw(seed, leaf, p.device))
