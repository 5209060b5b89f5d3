"""Paged KV and state cache for the continuous-batching serving runtime.

The serving cache replaces the dense, capacity-sized per-slot KV of the
static batch path with a *pool* of fixed-size pages plus per-slot block
tables:

  * :class:`PagePool` -- the host-side free-list allocator.  It owns the
    int32 block tables as numpy state; admission, growth and eviction move
    page *indices* on the host, never KV bytes on the device.
  * :func:`init_serving_cache` -- the device cache, one leaf per layer:
    an "attn" layer's :class:`~repro_torch.models.attention.PagedKVCache`
    pool; a "local" layer's dense ring
    (:class:`~repro_torch.models.attention.KVCache`, O(window) per slot),
    a "rec" layer's :class:`~repro_torch.models.rglru.RecurrentState` and
    an "ssm" layer's :class:`~repro_torch.models.ssd.SSMState` (O(1) per
    slot), all slot-major and dense.
  * :func:`write_prefill` -- copies one sequence's freshly prefilled dense
    cache (batch 1, capacity = length) into its slot, in place: KV rows into
    the slot's pool pages, ring entries re-slotted into the slot's ring,
    state rows into the slot's row.
  * :func:`refresh_tables` -- rewrites every paged layer's device block
    tables in place after the allocator moved pages.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.attention import (KVCache, PagedKVCache, PageSpec,
                                          quantize_kv_rows)
from repro_torch.models.rglru import RecurrentState
from repro_torch.models.ssd import SSMState


class OutOfPages(RuntimeError):
    """Admission/growth needs more pages than the free list holds."""


def pages_for(length: int, page_size: int) -> int:
    """Number of pages needed to hold ``length`` KV positions."""
    if length <= 0:
        return 0
    return -(-length // page_size)


class PagePool:
    """Host-side free-list page allocator + per-slot block tables.

    Invariants (checked by :meth:`check_invariants`):

      * every page id is owned by exactly one slot OR sits on the free
        list -- never both, never neither;
      * slot ``i`` owns exactly ``pages_for(len_i, P)`` pages, recorded
        in block-table order in ``tables[i, :nblocks]``.
    """

    def __init__(self, spec: PageSpec, num_slots: int):
        self.spec = spec
        self.num_slots = num_slots
        # pop() hands out ascending ids first -- deterministic allocation
        # order makes serving traces reproducible under a fixed seed.
        self._free: List[int] = list(range(spec.num_pages - 1, -1, -1))
        self._owned: List[List[int]] = [[] for _ in range(num_slots)]
        self.tables = np.zeros((num_slots, spec.max_blocks), np.int32)

    # -- queries ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def owned_pages(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    def slot_blocks(self, slot: int) -> int:
        return len(self._owned[slot])

    def can_admit(self, length: int, *, headroom: int = 0) -> bool:
        """Can a sequence of ``length`` positions (plus ``headroom``
        future decode tokens) be admitted right now?"""
        return pages_for(length + headroom,
                         self.spec.page_size) <= len(self._free)

    # -- mutation -----------------------------------------------------------

    def grow(self, slot: int, length: int) -> List[int]:
        """Ensure ``slot`` owns enough pages for ``length`` positions.

        Returns the newly allocated page ids (empty when the slot already
        covers ``length``).  Raises :class:`OutOfPages` when the free
        list cannot supply them and ValueError when ``length`` exceeds
        what ``max_blocks`` can ever map."""
        need = pages_for(length, self.spec.page_size)
        if need > self.spec.max_blocks:
            raise ValueError(
                f"length {length} needs {need} pages > max_blocks "
                f"{self.spec.max_blocks}")
        cur = len(self._owned[slot])
        if need <= cur:
            return []
        if need - cur > len(self._free):
            raise OutOfPages(
                f"slot {slot} needs {need - cur} pages, free list has "
                f"{len(self._free)}")
        new = [self._free.pop() for _ in range(need - cur)]
        self._owned[slot].extend(new)
        self.tables[slot, cur:need] = np.asarray(new, np.int32)
        return new

    def release(self, slot: int) -> int:
        """Free every page the slot owns; returns how many were freed."""
        freed = self._owned[slot]
        self._free.extend(freed)
        self._owned[slot] = []
        self.tables[slot, :] = 0
        return len(freed)

    # -- device views -------------------------------------------------------

    def device_tables(self, device) -> torch.Tensor:
        return to_device(self.tables, device)

    # -- checking -----------------------------------------------------------

    def check_invariants(self,
                         lengths: Optional[List[int]] = None) -> None:
        all_pages = sorted(self._free
                           + [p for o in self._owned for p in o])
        if all_pages != list(range(self.spec.num_pages)):
            raise AssertionError(
                f"page conservation broken: {all_pages}")
        for i, owned in enumerate(self._owned):
            n = len(owned)
            if list(self.tables[i, :n]) != owned:
                raise AssertionError(
                    f"slot {i} tables {self.tables[i, :n]} != owned {owned}")
            if lengths is not None:
                want = pages_for(lengths[i], self.spec.page_size)
                if n != want:
                    raise AssertionError(
                        f"slot {i} owns {n} pages, length {lengths[i]} "
                        f"wants {want}")


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``.  To the card it goes through pinned
    memory as a non-blocking copy, which does not wait for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


# ---------------------------------------------------------------------------
# Serving-cache helpers
# ---------------------------------------------------------------------------

def init_serving_cache(model, num_slots: int, spec: PageSpec):
    """The device cache for a continuous batch of ``num_slots`` slots."""
    capacity = spec.max_blocks * spec.page_size
    return model.init_cache(num_slots, capacity, paged=spec)


def _check_leaf(leaf) -> None:
    if not isinstance(leaf, (PagedKVCache, KVCache, RecurrentState,
                             SSMState)):
        raise NotImplementedError(f"serving-cache leaf {type(leaf).__name__}: "
                                  f"not a paged pool, a local ring or a "
                                  f"recurrent or SSM state")


def _write_ring(sv: KVCache, dv: KVCache, slot: int) -> None:
    """Re-slot a dense prefill ring's live entries into ring row ``slot``
    by ``pos % capacity``.  The two rings may differ in capacity, so the
    row is reset first: an evicted longer sequence would otherwise leave
    stale positions inside the window of the re-admitted one."""
    cap = sv.k.shape[1]
    pos = dv.pos[0].long()
    live = pos >= 0
    tgt = pos[live] % cap
    sv.k[slot].zero_()
    sv.v[slot].zero_()
    sv.pos[slot].fill_(-1)
    sv.k[slot, tgt] = dv.k[0, live].to(sv.k.dtype)
    sv.v[slot, tgt] = dv.v[0, live].to(sv.v.dtype)
    sv.pos[slot, tgt] = pos[live].to(sv.pos.dtype)


def write_prefill(serving, dense, *, slot: int, length: int, page_ids,
                  page_size: int):
    """Copy a batch-1 dense prefill cache into serving slot ``slot``.

    ``page_ids``: the slot's block-table prefix (from
    ``PagePool.grow``/``owned_pages``); it must cover ``length``.  For a
    paged leaf the dense prefill ran with capacity == length, so
    ``dense.k[0, :length]`` is position-ordered: it is padded to whole
    pages and scattered into the pools at the slot's pages, in place.  Into
    int8 pools the rows (padding included) go quantized per token, with the
    decode write's scaling, and their scales beside them.  A local ring
    is reset and its live entries re-slotted (:func:`_write_ring`).  A
    recurrent or SSM state leaf is a slot-major row copy, each tensor cast
    to the serving leaf's dtype (the reference's plain-leaf branch: a
    conv tail lands in bf16 until a decode step has promoted the serving
    leaf).  Returns the serving cache."""
    assert len(page_ids) == pages_for(length, page_size), \
        (len(page_ids), length, page_size)
    n = len(page_ids)
    pad = n * page_size - length
    ids = None
    for sv, dv in zip(serving, dense):
        _check_leaf(sv)
        if isinstance(sv, KVCache):
            _write_ring(sv, dv, slot)
            continue
        if isinstance(sv, (RecurrentState, SSMState)):
            for pool, rows in zip(sv, dv):
                pool[slot] = rows[0].to(pool.dtype)
            continue
        if ids is None:
            ids = to_device(np.asarray(page_ids, np.int64), sv.k.device)
        for pool, spool, rows in ((sv.k, sv.k_scale, dv.k),
                                  (sv.v, sv.v_scale, dv.v)):
            rows = rows[0, :length]
            if pad:
                rows = torch.cat([rows, rows.new_zeros((pad, *rows.shape[1:]))])
            rows = rows.reshape(n, page_size, *rows.shape[1:])
            if spool is None:
                pool[ids] = rows.to(pool.dtype)
            else:
                pool[ids], spool[ids] = quantize_kv_rows(rows)
    return serving


def refresh_tables(cache, tables):
    """Rewrite every paged layer's block tables in place with ``tables``
    ((num_slots, max_blocks) int32, host or device); called after the
    allocator moved pages.  Layers that share one table tensor
    (``stack_cache``) are written once; rings and states have no tables.
    Returns the cache."""
    t = done = None
    for leaf in cache:
        _check_leaf(leaf)
        if not isinstance(leaf, PagedKVCache):
            continue
        if t is None:
            t = tables if isinstance(tables, torch.Tensor) \
                else to_device(np.asarray(tables, np.int32), leaf.tables.device)
        if leaf.tables is not done:
            leaf.tables.copy_(t)
            done = leaf.tables
    return cache
