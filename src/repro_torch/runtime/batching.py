"""Continuous-batching scheduler over the paged serving cache.

The serving runtime decouples *requests* from *slots*: requests arrive on
a queue (Poisson-style in the benchmark trace), the scheduler admits them
into free decode slots as pool pages allow, and every decode step runs the
whole churning batch through ONE paged decode step
(:func:`repro_torch.runtime.steps.make_paged_serve_step`): batch
composition changes reach the device only as block-table and length
*values*, so the kernel state cached on the pool geometry is reused while
sequences come and go, and ``flash_decode`` launches once per layer per
step.

Scheduling policy (the reference's; deterministic, so evict -> re-admit is
greedy-token-identical to an uninterrupted run):

  * FIFO admission with head-of-line blocking: the queue head is admitted
    iff a slot is free and the free list covers its context plus one
    position of headroom for the first decode write; nothing behind it
    jumps ahead.
  * Per-step growth: before each decode step every active slot is grown to
    cover position ``length`` (the one being written).  When the pool runs
    dry, the *most recently admitted* other sequence is evicted: its pages
    are freed and it re-enters the queue front with its prompt and the
    tokens generated so far; re-admission re-prefills that context, which
    under greedy decoding reproduces the exact token stream.
  * Admission overflow never crashes: requests simply wait.

Every decoder-only family serves (internvl2-1b text-only; an
encoder-decoder is refused, as in the reference): attention layers through
paged pools, SSM layers through slot-major states (merged back for
inactive slots), MoE layers as they are (an inactive slot's garbage row routes and takes
capacity, as in the reference).  Host-side state is numpy and Python; the
device sees the step's inputs in one non-blocking copy, and the one host
sync per decode step is reading the new tokens back.  :meth:`warmup`
resolves and builds a recorded descriptor population, every prefill
length and the decode step before traffic.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.trace import span
from repro_torch.models.attention import PageSpec
from repro_torch.runtime import steps as steps_lib
from repro_torch.runtime.pages import (OutOfPages, PagePool,
                                       init_serving_cache, refresh_tables,
                                       to_device, write_prefill)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray        # (L,) int32
    max_new: int
    arrival: float = 0.0      # scheduler-tick time the request appears


@dataclasses.dataclass
class _Seq:
    """Host-side state of one admitted (or evicted-and-queued) request."""
    req: Request
    generated: List[int] = dataclasses.field(default_factory=list)
    evictions: int = 0
    admit_order: int = -1     # monotonic stamp of the latest admission
    t_visible: float = 0.0    # host time the request hit the queue
    t_last: float = 0.0       # host time of the previous emitted token

    @property
    def context(self) -> np.ndarray:
        """prompt + generated-so-far: what a re-prefill must replay."""
        gen = np.asarray(self.generated, np.int32)
        return np.concatenate([self.req.prompt.astype(np.int32), gen])

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.req.max_new


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ContinuousBatchingEngine:
    """Admission/eviction scheduler + single-launch paged decode loop over
    a ``LanguageModel``."""

    def __init__(self, model, *, num_slots: int, spec: PageSpec):
        cfg = model.cfg
        steps_lib.refuse_encoder_decoder(cfg, "continuous batching")
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.spec = spec
        self.num_slots = num_slots
        self.max_len = spec.max_blocks * spec.page_size

        self.pool = PagePool(spec, num_slots)
        self.cache = init_serving_cache(model, num_slots, spec)
        self._step = steps_lib.make_paged_serve_step(model)
        self._prefills: Dict[int, object] = {}  # context length -> step

        self.queue: deque = deque()
        self.slots: List[Optional[_Seq]] = [None] * num_slots
        self.lengths = np.zeros(num_slots, np.int64)
        self.next_token = np.zeros(num_slots, np.int64)
        self.tick = 0
        self.evictions = 0
        self._admit_counter = 0
        self.finished: Dict[int, _Seq] = {}
        self.token_latencies: List[float] = []
        self._tables_dirty = True
        # Host seconds per scheduler phase; "prefill" is deducted from the
        # admission block so the four never overlap.  On the card each
        # prefill ends in a synchronise, so it counts its device time.
        self.phase_seconds: Dict[str, float] = {
            "admission": 0.0, "prefill": 0.0, "decode": 0.0,
            "eviction": 0.0}

    # -- warm start ---------------------------------------------------------

    def warmup(self, prompt_lens=(), *, manifest: Optional[str] = None
               ) -> Dict:
        """Resolve and build what a serving run will touch, before traffic:
        ``engine.warmup`` over a descriptor manifest (or
        ``config.warm_start``), through the tuned tier, building each kernel
        once; one prefill per distinct length in ``prompt_lens``; one
        decode step on an all-inactive batch (no slot active: the pools and
        the state rows stay as they are).  A serving run with the same
        shapes then resolves no plan.  Returns a summary."""
        from repro_torch.core.config import get_config
        t0 = time.perf_counter()
        kernels: Dict[str, int] = {}
        if manifest is not None or get_config().warm_start:
            kernels = engine.warmup(manifest=manifest)
        lengths = sorted({int(L) for L in prompt_lens})
        for L in lengths:
            self._prefill_fn(L)({"tokens": torch.zeros(
                (1, L), dtype=torch.long, device=self.device)})
        zeros = torch.zeros(self.num_slots, dtype=torch.long,
                            device=self.device)
        _, self.cache, _ = self._step(self.cache, zeros[:, None], zeros,
                                      zeros.bool())
        _sync(self.device)
        return {"seconds": time.perf_counter() - t0, "kernels": kernels,
                "prefill_lengths": lengths}

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        seq = _Seq(req=req, t_visible=time.perf_counter())
        seq.t_last = seq.t_visible
        self.queue.append(seq)

    # -- internals ----------------------------------------------------------

    def _prefill_fn(self, length: int):
        fn = self._prefills.get(length)
        if fn is None:
            fn = steps_lib.make_prefill_step(self.model, length)
            self._prefills[length] = fn
        return fn

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit(self, seq: _Seq, slot: int) -> None:
        # A fresh admission prefills the prompt and emits its argmax, as
        # the static path does.  A RE-admission replays prompt + all but
        # the last generated token: exactly the cache an uninterrupted run
        # would hold (the last emitted token is not in the cache yet); the
        # next decode step recomputes from it.
        readmit = bool(seq.generated)
        ctx = seq.context[:-1] if readmit else seq.context
        L = len(ctx)
        page_ids = self.pool.owned_pages(slot)
        page_ids += self.pool.grow(slot, L)
        t0 = time.perf_counter()
        with span("sched.prefill", rid=seq.req.rid, len=L):
            tokens = to_device(ctx.astype(np.int64)[None, :], self.device)
            logits, dense = self._prefill_fn(L)({"tokens": tokens})
            write_prefill(self.cache, dense, slot=slot, length=L,
                          page_ids=page_ids, page_size=self.spec.page_size)
            _sync(self.device)
        self.phase_seconds["prefill"] += time.perf_counter() - t0
        if readmit:
            tok = seq.generated[-1]
        else:
            tok = int(torch.argmax(logits[0]))
            self._emit(seq, tok)
        self.slots[slot] = seq
        self.lengths[slot] = L
        self.next_token[slot] = tok
        self._tables_dirty = True

    def _emit(self, seq: _Seq, tok: int) -> None:
        now = time.perf_counter()
        seq.generated.append(tok)
        self.token_latencies.append(now - seq.t_last)
        seq.t_last = now

    def _release(self, slot: int) -> None:
        self.pool.release(slot)
        self.slots[slot] = None
        self.lengths[slot] = 0
        self._tables_dirty = True

    def _evict_for_growth(self, needy_slot: int) -> None:
        """Free pages by evicting the most recently admitted other slot."""
        victims = [i for i, s in enumerate(self.slots)
                   if s is not None and i != needy_slot]
        if not victims:
            raise OutOfPages(
                f"slot {needy_slot} cannot grow and no other sequence can "
                f"be evicted -- pool too small for one sequence")
        # LIFO victim: the most recently admitted sequence has the least
        # decode investment to replay on re-admission.
        t0 = time.perf_counter()
        victim = max(victims, key=lambda i: self.slots[i].admit_order)
        seq = self.slots[victim]
        seq.evictions += 1
        self.evictions += 1
        self._release(victim)
        self.queue.appendleft(seq)
        self.phase_seconds["eviction"] += time.perf_counter() - t0

    def _try_admissions(self) -> None:
        while self.queue:
            seq = self.queue[0]
            L = len(seq.context)
            if L + 1 > self.max_len:
                raise ValueError(
                    f"request {seq.req.rid} context {L}+1 exceeds "
                    f"max mappable length {self.max_len}")
            slot = self._free_slot()
            # +1 headroom: the first decode step writes position L.
            if slot is None or not self.pool.can_admit(L, headroom=1):
                break  # head-of-line blocking keeps admission FIFO-fair
            self.queue.popleft()
            self._admit_counter += 1
            seq.admit_order = self._admit_counter
            self._admit(seq, slot)

    def _retire(self) -> None:
        for slot, seq in enumerate(self.slots):
            if seq is not None and seq.done:
                self.finished[seq.req.rid] = seq
                self._release(slot)

    def _grow_active(self) -> None:
        for slot, seq in enumerate(self.slots):
            if seq is None:
                continue
            while True:
                try:
                    if self.pool.grow(slot, int(self.lengths[slot]) + 1):
                        self._tables_dirty = True
                    break
                except OutOfPages:
                    self._evict_for_growth(slot)

    # -- one scheduler tick -------------------------------------------------

    def step(self) -> int:
        """Retire finished sequences, admit what fits, grow, run ONE decode
        step over the live batch.  Returns the number of live slots this
        step decoded (0 = idle tick)."""
        t_admit = time.perf_counter()
        pf0 = self.phase_seconds["prefill"]
        with span("sched.admit"):
            self._retire()
            self._try_admissions()
            # Admission emits one token (the prefill argmax): sequences
            # that completed right there retire without ever decoding.
            self._retire()
        self.phase_seconds["admission"] += (
            time.perf_counter() - t_admit
            - (self.phase_seconds["prefill"] - pf0))
        self.tick += 1
        if not any(s is not None for s in self.slots):
            return 0
        # Growth may evict: the mask MUST be taken after it, or an evicted
        # slot would decode as active and write its KV through the zeroed
        # block table into page 0 (owned by someone else).
        with span("sched.grow"):
            self._grow_active()
            active_mask = np.array([s is not None for s in self.slots])
            n_active = int(active_mask.sum())
            if n_active == 0:
                return 0
            if self._tables_dirty:
                refresh_tables(self.cache,
                               self.pool.device_tables(self.device))
                self._tables_dirty = False
        t_dec = time.perf_counter()
        with span("sched.decode", active=n_active):
            inputs = to_device(np.stack([self.next_token, self.lengths,
                                         active_mask.astype(np.int64)]),
                               self.device)
            toks, self.cache, _ = self._step(self.cache, inputs[0][:, None],
                                             inputs[1], inputs[2].bool())
            with span("sched.readback"):
                toks = toks[:, 0].cpu().numpy()  # the step's one host sync
            for slot, seq in enumerate(self.slots):
                if seq is None or not active_mask[slot]:
                    continue
                self._emit(seq, int(toks[slot]))
                self.lengths[slot] += 1
                self.next_token[slot] = int(toks[slot])
        self.phase_seconds["decode"] += time.perf_counter() - t_dec
        return n_active

    # -- driver -------------------------------------------------------------

    def run(self, requests: List[Request], *,
            max_steps: int = 100_000) -> Dict:
        """Drive the scheduler until every request finished.

        Requests become visible when ``self.tick`` reaches their
        ``arrival`` (tick-time Poisson arrivals in the benchmark trace).
        Returns per-request outputs plus throughput / latency / launch
        metrics (host seconds)."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        stats0 = engine.stats()
        t0 = time.perf_counter()
        decode_steps = 0
        while pending or self.queue or any(s is not None
                                           for s in self.slots):
            while pending and pending[0].arrival <= self.tick:
                self.submit(pending.pop(0))
            if self.step():
                decode_steps += 1
            if self.tick > max_steps:
                raise RuntimeError("scheduler did not converge "
                                   f"within {max_steps} steps")
        wall = time.perf_counter() - t0
        stats1 = engine.stats()

        lat = np.asarray(self.token_latencies)
        total_tokens = sum(len(s.generated) for s in self.finished.values())
        fam = "flash_decode"
        launches = (stats1.get(fam, {}).get("launches", 0)
                    - stats0.get(fam, {}).get("launches", 0))
        return {
            "outputs": {rid: np.asarray(s.generated, np.int32)
                        for rid, s in self.finished.items()},
            "evictions": {rid: s.evictions
                          for rid, s in self.finished.items()},
            "metrics": {
                "requests": len(self.finished),
                "total_tokens": int(total_tokens),
                "decode_steps": decode_steps,
                "wall_seconds": wall,
                "tokens_per_s": total_tokens / max(wall, 1e-9),
                "p50_token_latency_s": float(np.percentile(lat, 50))
                if lat.size else 0.0,
                "p99_token_latency_s": float(np.percentile(lat, 99))
                if lat.size else 0.0,
                "evictions": self.evictions,
                "flash_decode_launches": int(launches),
                "phase_seconds": dict(self.phase_seconds),
            },
            "engine_stats": stats1,
        }


def poisson_trace(*, num_requests: int, rate: float, prompt_lens,
                  max_new, vocab_size: int, seed: int = 0) -> List[Request]:
    """A reproducible Poisson-style request trace, drawn exactly as the
    reference draws it (the same ``np.random.default_rng(seed)`` calls, so
    a seed gives the same requests in both packages).

    ``rate``: expected arrivals per scheduler tick; inter-arrival gaps
    are exponential.  ``prompt_lens``/``max_new`` may be ints or
    (lo, hi) ranges sampled uniformly."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if isinstance(spec, int):
            return spec
        lo, hi = spec
        return int(rng.integers(lo, hi + 1))

    t = 0.0
    out = []
    for rid in range(num_requests):
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        L = draw(prompt_lens)
        out.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab_size, size=L).astype(np.int32),
            max_new=draw(max_new),
            arrival=t))
    return out
