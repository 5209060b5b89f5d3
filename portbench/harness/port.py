"""The program under test: the port's public entry points, with the port's
defaults (``use(backend="engine", fused="auto")``, no autotune).  The only
module of the benchmark that imports ``repro_torch``."""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import sys
from typing import Dict

from harness.files import ROOT


def _import():
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch  # noqa: F401


def port_config(cfg_file: Dict):
    """The port's ``ModelConfig`` for a configuration file: the registered
    architecture with the file's ``model`` fields, each checked."""
    _import()
    from repro_torch.configs import get_config
    fields = dict(cfg_file["model"])
    fields["block_pattern"] = tuple(fields["block_pattern"])
    cfg = dataclasses.replace(get_config(cfg_file["arch"]), **fields)
    for key, want in fields.items():
        if getattr(cfg, key) != want:
            raise RuntimeError(f"{cfg_file['arch']}: {key} is "
                               f"{getattr(cfg, key)!r}, the file says {want!r}")
    return cfg


@contextlib.contextmanager
def defaults(device: str):
    _import()
    from repro_torch.core import use
    with use(backend="engine", fused="auto", device=device, autotune=False):
        yield


def build_model(cfg, cfg_file: Dict, seed: int, device: str):
    """The port's ``LanguageModel`` holding the benchmark's weights."""
    from harness.weights import load_into
    from repro_torch.models import LanguageModel
    model = LanguageModel(cfg, device=device, seed=0)
    load_into(model, cfg_file["model"], seed)
    return model


def serving_engine(model, *, slots: int, page_size: int, max_context: int):
    """``ContinuousBatchingEngine`` with pages for every slot at its longest
    context, so nothing is evicted."""
    from repro_torch.models.attention import PageSpec
    from repro_torch.runtime.batching import ContinuousBatchingEngine
    blocks = -(-(max_context + 1) // page_size)
    spec = PageSpec(num_pages=slots * blocks, page_size=page_size,
                    max_blocks=blocks)
    return ContinuousBatchingEngine(model, num_slots=slots, spec=spec)


def request(rid: int, prompt, max_new: int):
    from repro_torch.runtime.batching import Request
    return Request(rid=rid, prompt=prompt, max_new=max_new)


def training(cfg, model, lr: float, wrap_update):
    """(optimizer state, step): the port's ``adamw`` at a constant ``lr``,
    its ``update`` passed through ``wrap_update``, and
    ``make_train_step``'s step."""
    from repro_torch.convert import reference_shapes
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import Optimizer
    from repro_torch.runtime.steps import make_train_step
    opt = adamw(lr)
    opt = Optimizer(opt.init, wrap_update(opt.update))
    state = opt.init(dict(model.named_parameters()),
                     shapes=reference_shapes(cfg, model))
    return state, make_train_step(cfg, opt)


def adamw_defaults() -> Dict:
    from repro_torch.optim import adamw
    return {k: p.default for k, p in inspect.signature(adamw).parameters.items()
            if p.default is not inspect.Parameter.empty}


def engine_launches() -> int:
    from repro_torch.core import engine
    return sum(v for row in engine.stats().values()
               for k, v in row.items() if k.startswith("launches"))
