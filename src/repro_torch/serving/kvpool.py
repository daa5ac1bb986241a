"""Paged KV-cache arena: cross-request cache sharing for batched decode.

The per-client serving path gives every request its own full ``max_len``
cache pytree — RAM proportional to ``clients x max_len`` regardless of how
many tokens each client actually holds, and every scheduled decode step
stacks/splits those pytrees through the batching boundary. The arena
replaces that with ONE preallocated page pool per chain stage:

* every stage owns ``k``/``v`` arrays of shape
  ``(stage_layers, num_pages, page_size, kv_heads, head_dim)``;
* a sequence holds ``ceil(cur_len / page_size)`` pages, tracked in a host-
  side block table (sequence -> physical page ids, in logical order);
* pages are allocated at prefill (copy-on-prefill scatters the dense
  prefill cache into pages), extended one page at a time as decode crosses
  a page boundary, and returned to the free list when the request leaves —
  reuse is defrag-free because every page is identical.

Page 0 is a reserved scratch page that is never allocated: the continuous
batcher points empty decode slots' block-table rows at it, so a masked
slot's (discarded) token write can never land in a live sequence's memory.

Shared-prefix page cache
------------------------

Requests sharing a prompt prefix share the prefix's *pages*. Pages are
refcounted, and a content-addressed index maps prompt prefixes to live
pages at page granularity: each full page-sized token chunk gets a chained
``blake2b`` digest (so a hit at chunk ``i`` certifies the whole prefix
``[0, (i+1) * page)``), plus a whole-prompt key covering a partial tail.
:meth:`alloc_prefill` serves index hits by reference (refcount + 1) and
allocates fresh pages only past the cached prefix; registration activates
at :meth:`commit_prefill`, once the prefill has actually written the data.
Freed pages KEEP their index entries while on the free list (free-but-
cached) and are resurrected on a later hit; allocation prefers un-indexed
pages and purges a page's entries when it is reused for new content.

Writers never touch a shared page: prefill writes start past the cached
prefix, and :meth:`make_private` copies a page on the first divergent
write (copy-on-write), so the indexed page always holds exactly the
registered prefix.

RAM story (the paper's): platform RAM for serving is now proportional to
*unique pages held* — tokens actually resident, deduplicated across
requests — not to ``clients x max_len``;
:class:`~repro.core.billing.ArenaLease` bills each request for the pages
it held, amortized by refcount for shared ones.

The allocator is host-side (plain ints under ``_lock``, copied unchanged
from the JAX package); the page *data* are torch tensors on the engine's
device, written IN PLACE — decode and chunk steps write the new K/V rows
into the pool they are handed (``models/attention.py:
update_paged_kv``) and read pages through the block table (the kernels in
``kernels/paged_attention.py``). JAX swaps in new arrays after every step;
here ``swap_data`` stores back the same tensors, and the prefill scatter
and the CoW copy write into them. Every host-side write of ``self.data``
happens under ``_data_lock``, so two concurrent writers serialize.
"""
from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from repro_torch.analysis.guards import guarded_by
from repro_torch.device import resolve_device


class ArenaFull(RuntimeError):
    """No free pages left for an allocation (admission should back off)."""


class KVArena:
    """One page pool shared by every stage of a serving chain.

    ``stages`` maps stage name -> number of layers hosted by that stage;
    all stages share one allocator and one block table (a sequence occupies
    the same physical page ids in every stage's arrays, so one table row
    drives the whole chain's gather).
    """

    #: physical page 0 is scratch: masked/empty decode slots write here
    RESERVED_PAGE = 0

    # provlint: host-side bookkeeping is guarded by _lock; the device
    # tensors in `data` tolerate unlocked reads (GIL-atomic reference
    # loads) but every write must hold _data_lock.
    GUARDED_FIELDS = {
        "_free": "_lock",
        "_held": "_lock",
        "_lens": "_lock",
        "_peak_held": "_lock",
        "_refs": "_lock",
        "_index": "_lock",
        "_page_keys": "_lock",
        "_pending": "_lock",
        "_shared_upto": "_lock",
        "shared_hits": "_lock",
        "shared_pages_served": "_lock",
        "cow_copies": "_lock",
    }
    GUARDED_WRITES = {"data": "_data_lock"}

    def __init__(
        self,
        stages: dict[str, int],
        *,
        num_pages: int,
        page_size: int,
        kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got {page_size}")
        self.stages = dict(stages)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.device = resolve_device(device)
        shape = (num_pages, page_size, kv_heads, head_dim)
        self.data: dict[str, dict[str, torch.Tensor]] = {
            name: {
                kv: torch.zeros((n_layers, *shape), dtype=dtype, device=self.device)
                for kv in ("k", "v")
            }
            for name, n_layers in self.stages.items()
        }
        self._lock = threading.Lock()
        # guards every write to the page data (the allocator lock covers
        # only host-side page bookkeeping)
        self._data_lock = threading.Lock()
        # LIFO free list: recently-freed (cache-warm) pages are reused first
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._held: dict[object, list[int]] = {}
        self._lens: dict[object, int] = {}
        self._peak_held: dict[object, int] = {}
        # --- shared-prefix state ---
        self._refs: dict[int, int] = {}               # page -> holder count
        self._index: dict[bytes, int] = {}            # content key -> page
        self._page_keys: dict[int, list[bytes]] = {}  # page -> its index keys
        self._pending: dict[object, list[tuple[bytes, int]]] = {}
        self._shared_upto: dict[object, int] = {}     # leading pages held by ref
        self.shared_hits = 0          # prefills that reused >= 1 page
        self.shared_pages_served = 0  # pages served by reference, cumulative
        self.cow_copies = 0           # copy-on-write page copies

    # ------------------------------------------------------------ geometry

    @property
    def page_bytes(self) -> int:
        """Bytes ONE page occupies across the whole chain (all stages, k+v)
        — the unit of the per-request RAM bill."""
        per_layer = 2 * self.page_size * self.kv_heads * self.head_dim * self.dtype.itemsize
        return per_layer * sum(self.stages.values())

    def pages_for(self, length: int) -> int:
        return max(1, -(-int(length) // self.page_size))

    def max_pages_per_seq(self, max_len: int) -> int:
        if max_len % self.page_size:
            raise ValueError(f"max_len={max_len} must be a multiple of page_size={self.page_size}")
        return max_len // self.page_size

    # ------------------------------------------------------------ hashing

    def _page_digests(self, tokens: np.ndarray) -> list[bytes]:
        """One chained digest per FULL page-sized token chunk: digest i
        certifies the entire prefix [0, (i+1)*page), so a single index hit
        is a whole-prefix match, not a per-chunk one."""
        out: list[bytes] = []
        h = b""
        ps = self.page_size
        for i in range(len(tokens) // ps):
            h = hashlib.blake2b(
                b"P" + h + tokens[i * ps : (i + 1) * ps].tobytes(), digest_size=16
            ).digest()
            out.append(h)
        return out

    def _prompt_key(self, digests: list[bytes], tokens: np.ndarray) -> bytes:
        """Whole-prompt key (chain + partial tail + length): lets an EXACT
        repeat prompt share its partial last page too."""
        tail = tokens[len(digests) * self.page_size :]
        base = digests[-1] if digests else b""
        return hashlib.blake2b(
            b"W" + base + tail.tobytes() + len(tokens).to_bytes(8, "little"),
            digest_size=16,
        ).digest()

    # ------------------------------------------------------------ allocator

    @guarded_by("_lock")
    def _purge_keys_locked(self, page: int) -> None:
        for key in self._page_keys.pop(page, ()):
            if self._index.get(key) == page:
                del self._index[key]

    @guarded_by("_lock")
    def _pop_free_page_locked(self) -> int:
        """Pop a free page, preferring pages with no retained index entries
        (reusing an indexed free page evicts its cached prefix)."""
        if not self._free:
            raise ArenaFull("no free pages")
        for j in range(len(self._free) - 1, -1, -1):
            if self._free[j] not in self._page_keys:
                return self._free.pop(j)
        p = self._free.pop()
        self._purge_keys_locked(p)
        return p

    def alloc(self, seq_id, length: int) -> list[int]:
        """Reserve private pages for a sequence of ``length`` tokens.
        Raises :class:`ArenaFull` (allocating nothing) when the pool can't
        cover it. Content-aware allocation (prefix sharing) goes through
        :meth:`alloc_prefill` instead."""
        need = self.pages_for(length)
        with self._lock:
            if seq_id in self._held:
                raise ValueError(f"sequence {seq_id!r} already holds pages")
            if need > len(self._free):
                raise ArenaFull(f"need {need} pages, {len(self._free)} free")
            pages = [self._pop_free_page_locked() for _ in range(need)]
            for p in pages:
                self._refs[p] = 1
            self._held[seq_id] = pages
            self._lens[seq_id] = int(length)
            self._peak_held[seq_id] = need
            return list(pages)

    def alloc_prefill(self, seq_id, tokens) -> tuple[list[int], int]:
        """Content-aware allocation for a token prompt: leading pages whose
        chained prefix digests hit the index are served BY REFERENCE
        (refcount + 1, resurrecting free-but-cached pages), fresh pages
        cover the rest. Returns ``(pages, cached_tokens)`` —
        ``cached_tokens`` is how many leading prompt tokens already have
        resident KV (the prefill may start there; ``cached == len(tokens)``
        is a whole-prompt hit, partial tail page included).

        Registration of THIS prompt's chunks is recorded pending and
        activates at :meth:`commit_prefill` once the KV is written."""
        tok = np.asarray(tokens).reshape(-1).astype(np.int64)
        t_in = len(tok)
        if t_in == 0:
            raise ValueError("empty prompt")
        need_total = self.pages_for(t_in)
        digests = self._page_digests(tok)
        exact = t_in % self.page_size == 0
        prompt_key = None if exact else self._prompt_key(digests, tok)
        with self._lock:
            if seq_id in self._held:
                raise ValueError(f"sequence {seq_id!r} already holds pages")
            shared: list[int] = []
            for d in digests:
                p = self._index.get(d)
                if p is None:
                    break
                shared.append(p)
            cached = min(len(shared) * self.page_size, t_in)
            if prompt_key is not None and len(shared) == len(digests):
                tail = self._index.get(prompt_key)
                if tail is not None and tail not in shared:
                    shared.append(tail)
                    cached = t_in
            fresh_need = need_total - len(shared)
            resurrect = sum(1 for p in shared if p not in self._refs)
            if fresh_need > len(self._free) - resurrect:
                raise ArenaFull(
                    f"need {fresh_need} fresh pages, "
                    f"{len(self._free) - resurrect} free after sharing"
                )
            for p in shared:
                if p in self._refs:
                    self._refs[p] += 1
                else:  # free-but-cached: pull it back off the free list
                    self._free.remove(p)
                    self._refs[p] = 1
            fresh = [self._pop_free_page_locked() for _ in range(fresh_need)]
            for p in fresh:
                self._refs[p] = 1
            pages = shared + fresh
            self._held[seq_id] = pages
            self._lens[seq_id] = t_in
            self._peak_held[seq_id] = need_total
            self._shared_upto[seq_id] = len(shared)
            if shared:
                self.shared_hits += 1
                self.shared_pages_served += len(shared)
            pend = [(d, i) for i, d in enumerate(digests) if d not in self._index]
            if prompt_key is not None and prompt_key not in self._index:
                pend.append((prompt_key, need_total - 1))
            if pend:
                self._pending[seq_id] = pend
            return list(pages), cached

    def commit_prefill(self, seq_id) -> None:
        """Activate the prefix-index registrations recorded at
        :meth:`alloc_prefill` — call once the prefill has WRITTEN the
        pages' KV (serving an unwritten page by reference would hand out
        zeros)."""
        with self._lock:
            pend = self._pending.pop(seq_id, ())
            pages = self._held.get(seq_id)
            if pages is None:
                return
            for key, idx in pend:
                if key in self._index:
                    continue  # a concurrent prefill registered it first
                p = pages[idx]
                self._index[key] = p
                self._page_keys.setdefault(p, []).append(key)

    def shared_pages(self, seq_id) -> int:
        """How many of a sequence's leading pages came from the prefix
        cache (held by reference, never written by this sequence)."""
        with self._lock:
            return self._shared_upto.get(seq_id, 0)

    def extend(self, seq_id, new_len: int) -> list[int]:
        """Grow a sequence to ``new_len`` tokens, appending pages as the
        length crosses page boundaries. Returns the pages added."""
        with self._lock:
            if seq_id not in self._held:
                raise KeyError(f"unknown sequence {seq_id!r}")
            if new_len < self._lens[seq_id]:
                raise ValueError("sequences never shrink; free and realloc instead")
            need = self.pages_for(new_len) - len(self._held[seq_id])
            if need > len(self._free):
                raise ArenaFull(f"need {need} more pages, {len(self._free)} free")
            added = [self._pop_free_page_locked() for _ in range(need)]
            for p in added:
                self._refs[p] = 1
            self._held[seq_id].extend(added)
            self._lens[seq_id] = int(new_len)
            self._peak_held[seq_id] = max(self._peak_held[seq_id], len(self._held[seq_id]))
            return added

    def free(self, seq_id) -> int:
        """Drop a sequence's page references; pages whose refcount hits
        zero return to the pool — KEEPING their prefix-index entries
        (free-but-cached) until the page is reused. Returns how many pages
        the sequence held."""
        with self._lock:
            pages = self._held.pop(seq_id, None)
            self._lens.pop(seq_id, None)
            self._peak_held.pop(seq_id, None)
            self._pending.pop(seq_id, None)
            self._shared_upto.pop(seq_id, None)
            if pages is None:
                return 0
            for p in reversed(pages):
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    del self._refs[p]
                    self._free.append(p)
            return len(pages)

    def make_private(self, seq_id, pos: int) -> bool:
        """Copy-on-write: ensure the page holding token position ``pos`` is
        exclusively owned by ``seq_id`` before a write lands there. If the
        page is shared (refcount > 1), copy its data to a fresh page and
        swap it into this sequence's table. Returns True when the block row
        changed (callers must rebuild it). Raises :class:`ArenaFull` when
        no page is free for the copy.

        The copy is made (on the card: issued) while the allocator lock is
        held, before this sequence's reference to the shared page is gone
        for other threads: once it is, the page's other holder may free it
        and a new sequence may be given it and write its own prefill there,
        which a copy made after the lock (the reference's order) would read.
        The nesting is ``_lock`` -> ``_data_lock``, and no path takes them in
        the other order."""
        with self._lock:
            pages = self._held.get(seq_id)
            if pages is None:
                raise KeyError(f"unknown sequence {seq_id!r}")
            idx = int(pos) // self.page_size
            if idx >= len(pages):
                raise ValueError(f"position {pos} past {seq_id!r}'s pages (extend first)")
            old = pages[idx]
            if self._refs.get(old, 0) <= 1:
                return False
            new = self._pop_free_page_locked()
            with self._data_lock:
                for stage in self.data.values():
                    for arr in stage.values():
                        arr[:, new].copy_(arr[:, old])
            self._refs[new] = 1
            self._refs[old] -= 1
            pages[idx] = new
            if self._shared_upto.get(seq_id, 0) > idx:
                self._shared_upto[seq_id] = idx
            self.cow_copies += 1
        return True

    # ------------------------------------------------------------ queries

    def pages_held(self, seq_id) -> int:
        with self._lock:
            return len(self._held.get(seq_id, ()))

    def peak_pages(self, seq_id) -> int:
        with self._lock:
            return self._peak_held.get(seq_id, 0)

    def amortized_pages(self, seq_id) -> float:
        """The sequence's page count with each page weighted by 1/refcount
        — a fleet sharing a prefix splits its bill (sampled at call time;
        the batcher samples on exit)."""
        with self._lock:
            pages = self._held.get(seq_id, ())
            return float(sum(1.0 / self._refs[p] for p in pages))

    def seq_len(self, seq_id) -> int:
        with self._lock:
            return self._lens.get(seq_id, 0)

    def block_row(self, seq_id, width: int) -> np.ndarray:
        """The sequence's block-table row, padded with the scratch page to
        ``width`` entries (int32)."""
        with self._lock:
            return self._block_row_locked(seq_id, width)

    @guarded_by("_lock")
    def _block_row_locked(self, seq_id, width: int) -> np.ndarray:
        pages = self._held.get(seq_id, [])
        if len(pages) > width:
            raise ValueError(f"{seq_id!r} holds {len(pages)} pages > table width {width}")
        row = np.full((width,), self.RESERVED_PAGE, np.int32)
        row[: len(pages)] = pages
        return row

    def used_pages(self) -> int:
        """Unique physical pages in use (shared pages count once)."""
        with self._lock:
            return len(self._refs)

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def check_consistency(self) -> None:
        """Fuzz-test invariant, extended to refcounted sharing: every
        non-reserved page is free xor held; a held page's refcount equals
        the number of sequences holding it; every row covers its sequence's
        length; index entries point at real pages and back-links match."""
        with self._lock:
            holders: dict[int, int] = {}
            for sid, pages in self._held.items():
                if len(pages) != self.pages_for(self._lens[sid]):
                    raise AssertionError(
                        f"{sid!r}: {len(pages)} pages for len {self._lens[sid]}"
                    )
                if len(set(pages)) != len(pages):
                    raise AssertionError(f"{sid!r} holds a page twice: {pages}")
                for p in pages:
                    if not 0 < p < self.num_pages:
                        raise AssertionError(f"page {p} out of range (or reserved)")
                    holders[p] = holders.get(p, 0) + 1
            for p, n in holders.items():
                if self._refs.get(p) != n:
                    raise AssertionError(
                        f"page {p}: refcount {self._refs.get(p)} != {n} holders"
                    )
            for p in self._refs:
                if p not in holders:
                    raise AssertionError(f"page {p} refcounted but held by no one")
            seen_free: set[int] = set()
            for p in self._free:
                if p in holders:
                    raise AssertionError(f"page {p} both free and held")
                if p in seen_free:
                    raise AssertionError(f"page {p} on the free list twice")
                if not 0 < p < self.num_pages:
                    raise AssertionError(f"free page {p} out of range (or reserved)")
                seen_free.add(p)
            if len(seen_free) + len(holders) != self.num_pages - 1:
                missing = set(range(1, self.num_pages)) - seen_free - set(holders)
                raise AssertionError(f"leaked pages: {sorted(missing)}")
            for key, p in self._index.items():
                if p not in holders and p not in seen_free:
                    raise AssertionError(f"index key -> nonexistent page {p}")
                if key not in self._page_keys.get(p, ()):
                    raise AssertionError(f"index key for page {p} missing back-link")
            for p, keys in self._page_keys.items():
                for key in keys:
                    if self._index.get(key) != p:
                        raise AssertionError(f"stale page-key on page {p}")

    def stats(self) -> dict:
        with self._lock:
            held = {str(k): len(v) for k, v in self._held.items()}
            return {
                "num_pages": self.num_pages,
                "page_size": self.page_size,
                "page_bytes": self.page_bytes,
                "free": len(self._free),
                "used": len(self._refs),
                "held_nominal": sum(held.values()),
                "sequences": len(held),
                "held_by_seq": held,
                "shared_hits": self.shared_hits,
                "shared_pages_served": self.shared_pages_served,
                "cow_copies": self.cow_copies,
                "prefix_index": len(self._index),
            }

    # ------------------------------------------------------------ page data

    def write_prefill(self, seq_id, stage_caches: dict, length: int) -> None:
        """Copy-on-prefill: scatter a request's dense prefill caches into
        its allocated pages. ``stage_caches[stage]`` is the chain's dense
        cache for ONE request — ``{'k','v'}`` of shape ``(L, 1, S, kv, hd)``
        or ``(L, S, kv, hd)`` — with the first ``length`` positions valid.

        Pages obtained from the prefix cache are SKIPPED: they already hold
        the prefix KV, and they may be shared — rewriting one would clobber
        a co-holder's tail-page decode writes. The in-place scatter runs
        under ``_data_lock``."""
        with self._lock:
            pages = list(self._held.get(seq_id, ()))
            skip = self._shared_upto.get(seq_id, 0)
        if not pages:
            raise KeyError(f"no pages allocated for {seq_id!r}")
        for stage in stage_caches:
            if stage not in self.data:
                raise KeyError(
                    f"unknown arena stage {stage!r} (have {sorted(self.data)})"
                )
        n = self.pages_for(length)
        if skip >= n:
            return  # whole prefix served from the cache: nothing to write
        ids = torch.tensor(pages[skip:n], dtype=torch.long, device=self.device)
        lo = skip * self.page_size
        span = n * self.page_size
        with self._data_lock:
            for stage, cache in stage_caches.items():
                dst = self.data[stage]
                for kv in ("k", "v"):
                    src = cache[kv]
                    if src.ndim == 5:  # (L, 1, S, kv, hd) -> (L, S, kv, hd)
                        src = src[:, 0]
                    if src.shape[1] < span:
                        raise ValueError(
                            f"prefill cache covers {src.shape[1]} positions < {span} paged"
                        )
                    chunks = src[:, lo:span].reshape(
                        src.shape[0], n - skip, self.page_size, self.kv_heads, self.head_dim
                    )
                    dst[kv][:, ids] = chunks.to(device=self.device, dtype=self.dtype)

    def swap_data(self, stage: str, new: dict) -> None:
        """Store back a stage's page tensors (a decode/chunk step's output:
        the same tensors, written in place) under the data lock."""
        with self._data_lock:
            self.data[stage] = new

    def gather(self, seq_id, stage: str, width: int | None = None) -> dict:
        """Contiguous view of one sequence's cache for a stage — the test
        oracle (and the shape the gather-fallback decode reconstructs).
        Returns ``{'k','v'}`` of shape (L, width*page, kv, hd).

        The (pages, default width) snapshot is taken under ONE lock
        acquisition: deriving the width from ``seq_len`` and re-reading the
        page list separately would race a concurrent ``extend`` into a
        spurious ValueError for a perfectly healthy sequence."""
        with self._lock:
            pages = self._held.get(seq_id, [])
            if width is None:
                width = max(1, len(pages))
            row_np = self._block_row_locked(seq_id, width)
        row = torch.from_numpy(row_np).to(self.device).long()
        out = {}
        for kv in ("k", "v"):
            pages_v = self.data[stage][kv][:, row]  # (L, width, page, kv, hd)
            l = pages_v.shape[0]
            out[kv] = pages_v.reshape(l, width * self.page_size, self.kv_heads, self.head_dim)
        return out
