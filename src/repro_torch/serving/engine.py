"""Serving engine: deploys a model on the Provuse platform as a FaaS
function *chain* and serves prefill/decode through it.

Chain layout (the block families: dense, MoE and SSM):

    <arch>/embed  ->  <arch>/g0  ->  ...  ->  <arch>/g{G-1}  ->  <arch>/head

The hybrid family deploys ``<arch>/embed -> <arch>/core -> <arch>/head``:
the core holds every Mamba group and the shared attention block.

Each stage is an independently deployed function holding its own layer-slice
weights; every stage synchronously calls the next and returns the final
result back up the chain — while the head computes, every upstream instance
is blocked (the paper's double-billing chain).

The platform observes the synchronous edges during live traffic and fuses
the chain step by step into a single unit per request type — no code here
ever asks for fusion; it *happens to* the deployment (transparent,
platform-side). Per-token latency before/after is the paper's Fig. 5.

Stage functions are shape-polymorphic: a (B, T>1) input takes the prefill
path (and fills the preallocated max_len cache; an SSM stage's built state
simply becomes its cache); (B, 1) takes the decode path. One deployed
function serves both request types. Dense caches are never written in
place: every stage returns new cache tensors, so a canary replay sees the
cache its request saw.

Paged serving: with ``enable_paging`` the chain can also serve from a shared
:class:`~repro_torch.serving.kvpool.KVArena` — ``caches`` then carries a
block table plus each stage's page-pool slice instead of per-client dense
caches, and the SAME deployed (possibly fused) chain reads and writes arena
pages: single-token decode steps for a whole batch (K1) and chunked prompt
prefill (K2). The arena's tensors are written in place, so paged requests
record no canary (``FunctionHandler.no_canaries``); merge health checks
replay dense-prefill canaries. Fused and unfused chains serve from one
arena (see ``serving/continuous.py`` for the decode loop that keeps it busy).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.analysis.dispatch import TRACER
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.function import FunctionSpec
from repro_torch.core.platform import ProvusePlatform
from repro_torch.device import resolve_device
from repro_torch.models import hybrid as hy
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, embed_tokens, unembed
from repro_torch.models.model import Model
from repro_torch.models.params import init_params
from repro_torch.serving.kvpool import KVArena


def _greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling on the device: (B, V) logits -> (B, 1) int32 tokens."""
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


class PagedPrefillJob:
    """Host-side cursor for one chunked paged prefill: ``pos`` tracks how
    many prompt tokens already have resident KV (cached prefix pages count
    immediately), ``t_in`` is the full prompt length."""

    __slots__ = ("seq_id", "tokens", "pos")

    def __init__(self, seq_id, tokens: np.ndarray, pos: int):
        self.seq_id = seq_id
        self.tokens = tokens  # (t_in,) int32, on the host
        self.pos = pos

    @property
    def t_in(self) -> int:
        return len(self.tokens)

    @property
    def remaining(self) -> int:
        return self.t_in - self.pos


def _host_tokens(tokens) -> np.ndarray:
    """A prompt as a host int32 array (a numpy array or a torch tensor; one
    on the card costs a device-to-host copy, so keep prompts on the host)."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    return np.asarray(tokens, dtype=np.int32)


def _slice_tree(t, lo: int, hi: int):
    return tree.map(lambda x: x[lo:hi], t)


def _fill_prefix(full: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """A NEW tensor: ``full`` with ``part`` in its leading sequence slots
    (axis 2: (layers, B, S, KV, hd)); ``full`` itself is not written."""
    filled = full.clone()
    filled[:, :, : part.shape[2]] = part.to(full.dtype)
    return filled


def _pick_groups(n_layers: int, requested: int) -> int:
    g = min(requested, n_layers)
    while g > 1 and n_layers % g:
        g -= 1
    return max(1, g)


class ServingEngine:
    def __init__(self, model: Model, platform: ProvusePlatform, *, max_len: int = 256,
                 params=None, trust_domain: str | None = None, device=None, seed: int = 0,
                 kv_pages: int = 0, kv_page_size: int = 16):
        self.model = model
        self.cfg = model.cfg
        self.platform = platform
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = params if params is not None else model.init(seed, device=self.device)
        self.prefix = self.cfg.name
        self.trust = trust_domain or self.cfg.name
        self.entry = f"{self.prefix}/embed"
        self.arena: KVArena | None = None
        if self.cfg.family == "hybrid":
            self._deploy_monolithic_chain()
        else:
            self._deploy_blocks_chain()
        if kv_pages:
            self.enable_paging(kv_pages, kv_page_size)

    # ------------------------------------------------------------ chain

    def _deploy_blocks_chain(self) -> None:
        cfg = self.cfg
        L = cfg.num_layers
        g = _pick_groups(L, cfg.num_function_groups)
        per = L // g
        kind = tfm.layer_kind(cfg)
        names = [f"{self.prefix}/g{i}" for i in range(g)]
        head_name = f"{self.prefix}/head"

        def embed_fn(ctx, params, inputs, cur_len, caches):
            return ctx.call(names[0], embed_tokens(params, inputs["tokens"]), cur_len, caches)

        self.platform.deploy(
            FunctionSpec(self.entry, embed_fn, {"table": self.params["embed"]["table"]}, self.trust)
        )

        def make_group_fn(i: int):
            key = f"g{i}"
            nxt = names[i + 1] if i + 1 < g else head_name

            def group_fn(ctx, params, x, cur_len, caches):
                if "block_table" in caches:  # paged: caches hold the arena
                    if "chunk_valid" in caches:  # chunked-prefill rows
                        h, arena = tfm.apply_stack_prefill_chunk_paged(
                            params, x, caches[key], caches["block_table"], cfg, kind, cur_len,
                            caches["chunk_valid"],
                        )
                    else:  # single-token decode ("__frozen__" = no KV write)
                        h, arena = tfm.apply_stack_decode_paged(
                            params, x, caches[key], caches["block_table"], cfg, kind, cur_len,
                            "__frozen__" not in caches,
                        )
                    caches = dict(caches)
                    caches[key] = arena
                    return ctx.call(nxt, h, cur_len, caches)
                old = caches[key]
                if x.shape[1] == 1:  # decode
                    h, new_cache = tfm.apply_stack_decode(params, x, old, cfg, kind, cur_len)
                else:  # prefill: build the cache and place it in the max_len slots
                    positions = torch.arange(x.shape[1], device=x.device)[None, :]
                    h, built = tfm.apply_stack_full(params, x, cfg, kind, positions, collect_cache=True)
                    if kind == "ssm":  # the built state IS the cache
                        new_cache = built
                    else:
                        new_cache = {name: _fill_prefix(full, built[name]) for name, full in old.items()}
                caches = dict(caches)
                caches[key] = new_cache
                return ctx.call(nxt, h, cur_len, caches)

            return group_fn

        blocks = self.params["blocks"]
        for i, name in enumerate(names):
            self.platform.deploy(
                FunctionSpec(name, make_group_fn(i), _slice_tree(blocks, i * per, (i + 1) * per), self.trust)
            )

        def head_fn(ctx, params, x, cur_len, caches):
            if "chunk_valid" in caches:
                # chunked prefill pads the chunk to a power of two: the last
                # REAL row's hidden state is at chunk_valid - 1, not -1 (a
                # tensor index: no host read inside the chain)
                h = x.index_select(1, caches["chunk_valid"].long() - 1)
            else:
                h = x[:, -1:]
            h = apply_norm(params["ln_f"], h, cfg)
            return unembed(params["embed"], h)[:, 0], caches

        self.platform.deploy(
            FunctionSpec(head_name, head_fn, {"ln_f": self.params["ln_f"], "embed": self.params["embed"]}, self.trust)
        )
        self.group_names = names

    def _deploy_monolithic_chain(self) -> None:
        """The hybrid family's chain, embed -> core -> head: the core holds
        every Mamba group and the shared block. On prefill the SSM states are
        the built ones and the attention caches land in their max_len slots
        as new tensors."""
        cfg = self.cfg
        core_name = f"{self.prefix}/core"
        head_name = f"{self.prefix}/head"

        def embed_fn(ctx, params, inputs, cur_len, caches):
            return ctx.call(core_name, embed_tokens(params, inputs["tokens"]), cur_len, caches)

        def core_fn(ctx, params, x, cur_len, caches):
            if x.shape[1] == 1:  # decode
                h, new_caches = hy.apply_hybrid_decode(params, x, caches, cfg, cur_len)
            else:  # prefill
                positions = torch.arange(x.shape[1], device=x.device)[None, :]
                # new max_len attention caches, each application's K/V written
                # into them as it is made (no stacked copy held beside them)
                attn = {name: full.clone() for name, full in caches["attn"].items()}
                h, built = hy.apply_hybrid_full(params, x, cfg, positions, collect_cache=True, attn_into=attn)
                new_caches = {**caches, **built}
            return ctx.call(head_name, h, cur_len, new_caches)

        def head_fn(ctx, params, x, cur_len, caches):
            h = apply_norm(params["ln_f"], x[:, -1:], cfg)
            return unembed(params["embed"], h)[:, 0], caches

        self.platform.deploy(
            FunctionSpec(self.entry, embed_fn, {"table": self.params["embed"]["table"]}, self.trust)
        )
        self.platform.deploy(FunctionSpec(core_name, core_fn, self.params["hybrid"], self.trust))
        self.platform.deploy(
            FunctionSpec(head_name, head_fn, {"ln_f": self.params["ln_f"], "embed": self.params["embed"]}, self.trust)
        )

    def chain_names(self) -> list[str]:
        """Every function name this engine deployed, in chain order."""
        if self.cfg.family == "hybrid":
            return [self.entry, f"{self.prefix}/core", f"{self.prefix}/head"]
        return [self.entry, *self.group_names, f"{self.prefix}/head"]

    # ------------------------------------------------------------ caches

    def empty_caches(self, batch: int):
        """Zeroed max_len caches: re-keyed by chain stage for the block
        families (an SSM stage's states included), the model's own layout
        for the hybrid."""
        shape = ShapeConfig("serve", self.max_len, batch, "decode")
        cache = init_params(self.model.cache_defs(shape), device=self.device)
        if self.cfg.family == "hybrid":
            return cache
        g = len(self.group_names)
        per = self.cfg.num_layers // g
        return {f"g{i}": _slice_tree(cache, i * per, (i + 1) * per) for i in range(g)}

    # ------------------------------------------------------------ paging

    @property
    def paging_supported(self) -> bool:
        """Paged KV applies to length-indexed attention caches: an SSM state
        is recurrent, and the hybrid keeps its dedicated layout."""
        return self.cfg.family in ("dense", "moe", "vlm")

    def enable_paging(self, num_pages: int, page_size: int = 16) -> KVArena:
        """Preallocate the shared KV arena on the engine's device: one
        (layers, pages, page, KV, hd) pool per chain stage, one allocator and
        block table across stages."""
        if not self.paging_supported:
            raise ValueError(f"paged KV unsupported for family {self.cfg.family!r}")
        if self.max_len % page_size:
            raise ValueError(f"max_len={self.max_len} must be a multiple of page_size={page_size}")
        g = len(self.group_names)
        per = self.cfg.num_layers // g
        self.arena = KVArena(
            {f"g{i}": per for i in range(g)},
            num_pages=num_pages,
            page_size=page_size,
            kv_heads=self.cfg.num_kv_heads,
            head_dim=self.cfg.head_dim,
            dtype=getattr(torch, self.cfg.kv_cache_dtype),
            device=self.device,
        )
        self.block_width = self.arena.max_pages_per_seq(self.max_len)
        return self.arena

    def _to_device(self, x) -> torch.Tensor:
        """A host array or tensor as a NEW int32 tensor on the engine's
        device (never a view of a caller's buffer that it goes on mutating)."""
        return torch.as_tensor(x, dtype=torch.int32).to(self.device, copy=True)

    def _invoke_paged(self, args: tuple):
        """One paged request through the chain: the no-canary path (the
        arena is written in place, so a replay could not reproduce it, and
        ``invoke`` would pin the whole pool as the canary). Demand is noted
        so the fusion policy sees serve traffic as client load."""
        self.platform.handler.note_demand(self.entry)
        with self.platform.handler.no_canaries():
            return self.platform._invoke_with_retry(self.entry, args)

    def prefill_paged(self, seq_id, inputs: dict):
        """Admit one request into the arena: dense chain prefill, then
        copy-on-prefill scatters the built cache into freshly allocated
        pages and the dense caches are dropped.

        Prompts go through the arena's shared-prefix cache: leading pages
        whose content hashes hit are held by reference and skipped by the
        scatter; a whole-prompt hit skips the dense prefill entirely — one
        frozen decode step at the last prompt position recovers the
        first-token logits from the cached pages. Returns (last logits
        (1, V), prompt length)."""
        assert self.arena is not None, "enable_paging first"
        tokens = _host_tokens(inputs["tokens"])
        t_in = tokens.shape[1]
        _, cached = self.arena.alloc_prefill(seq_id, tokens[0])
        try:
            if cached >= t_in:
                logits = self._frozen_first_token(seq_id, tokens)
            else:
                logits, caches, _ = self.prefill({"tokens": self._to_device(tokens)})
                self.arena.write_prefill(seq_id, caches, t_in)
            self.arena.commit_prefill(seq_id)
        except BaseException:
            self.arena.free(seq_id)
            raise
        return logits, t_in

    def _frozen_first_token(self, seq_id, tokens: np.ndarray):
        """First-token logits for a whole-prompt prefix-cache hit: every
        page is already resident, so ONE frozen (no-KV-write) decode step at
        position t_in - 1 reads them back — nothing shared is touched."""
        t_in = tokens.shape[1]
        row = self.arena.block_row(seq_id, self.block_width)
        return self.paged_decode_step(
            tokens[:, -1:], np.asarray([t_in - 1], np.int32), row[None, :], write_kv=False
        )

    def begin_prefill_paged(self, seq_id, inputs: dict) -> PagedPrefillJob:
        """Allocate pages for a token prompt (through the shared-prefix
        cache) and return a chunked-prefill cursor — drive it with
        :meth:`prefill_chunk_paged` between decode steps. The cursor starts
        past any cached prefix. The prompt stays on the host."""
        assert self.arena is not None, "enable_paging first"
        tokens = _host_tokens(inputs["tokens"])[0]
        _, cached = self.arena.alloc_prefill(seq_id, tokens)
        return PagedPrefillJob(seq_id=seq_id, tokens=tokens, pos=int(cached))

    def prefill_chunk_paged(self, job: PagedPrefillJob, max_tokens: int):
        """Advance a chunked prefill by up to ``max_tokens`` prompt tokens:
        one chain invocation writes the chunk's KV into the job's pages and
        attends causally from the chunk's start offset. Returns the
        first-token logits (1, V) once the prompt is fully processed, else
        None. The chunk buffer is padded to the next power of two (the real
        count rides in ``chunk_valid``), so a unit sees O(log max_len)
        chunk shapes, not one per length. Only the padded chunk, its start
        and its valid count move to the device."""
        assert self.arena is not None, "enable_paging first"
        t_in = job.t_in
        if job.pos >= t_in:  # whole-prompt hit: nothing to compute
            logits = self._frozen_first_token(job.seq_id, job.tokens[None, :])
            self.arena.commit_prefill(job.seq_id)
            return logits
        c = max(1, min(int(max_tokens), t_in - job.pos))
        padded = 1 << (c - 1).bit_length()
        buf = np.zeros((1, padded), np.int32)
        buf[0, :c] = job.tokens[job.pos : job.pos + c]
        row = self.arena.block_row(job.seq_id, self.block_width)
        caches = self.paged_caches(row[None, :])
        caches["chunk_valid"] = self._to_device([c])
        args = ({"tokens": self._to_device(buf)}, self._to_device([job.pos]), caches)
        logits, caches = self._invoke_paged(args)
        for name in self.arena.data:
            self.arena.swap_data(name, caches[name])
        job.pos += c
        if job.pos >= t_in:
            self.arena.commit_prefill(job.seq_id)
            return logits
        return None

    def paged_caches(self, block_table) -> dict:
        """Assemble the ``caches`` tree for a batch served from the arena:
        the block table (moved to the device) plus every stage's page pool."""
        assert self.arena is not None, "enable_paging first"
        caches = {"block_table": self._to_device(block_table)}
        for name, stage in self.arena.data.items():
            caches[name] = stage
        return caches

    def paged_decode_step(self, tokens, cur_len, block_table, *, write_kv: bool = True):
        """One decode step for a batch whose caches live in the arena.
        tokens: (B, 1); cur_len: (B,) — ragged per-request lengths;
        block_table: (B, width); host arrays or tensors. The step writes the
        new tokens' K/V into the arena in place.

        ``write_kv=False`` runs the FROZEN variant (shared-prefix whole-hit
        admission): the step reads pages and writes nothing. The marker
        rides in the caches tree, so the frozen step is its own unit."""
        TRACER.note_decode_step()
        caches = self.paged_caches(block_table)
        if not write_kv:
            caches["__frozen__"] = ()
        args = ({"tokens": self._to_device(tokens)}, self._to_device(cur_len), caches)
        logits, caches = self._invoke_paged(args)
        if write_kv:
            for name in self.arena.data:
                self.arena.swap_data(name, caches[name])
        return logits

    def _block_table_for(self, seq_ids) -> np.ndarray:
        rows = [self.arena.block_row(s, self.block_width) for s in seq_ids]
        return np.stack(rows)

    # ------------------------------------------------------------ serving API

    def prefill(self, inputs: dict, caches=None):
        b, t_in = inputs["tokens"].shape
        if caches is None:
            caches = self.empty_caches(b)
        cur_len = torch.full((b,), t_in, dtype=torch.int32, device=self.device)
        logits, caches = self.platform.invoke(self.entry, inputs, cur_len, caches)
        return logits, caches, cur_len

    def decode_step(self, tokens, cur_len, caches):
        TRACER.note_decode_step()
        return self.platform.invoke(self.entry, {"tokens": tokens}, cur_len, caches)

    def decode_step_async(self, tokens, cur_len, caches):
        """Scheduled decode step: returns a Future of (logits, caches).
        Concurrent clients decoding with the same shapes coalesce into one
        micro-batched execution on the (possibly fused) chain."""
        TRACER.note_decode_step()
        return self.platform.invoke_async(self.entry, {"tokens": tokens}, cur_len, caches)

    def generate(self, inputs: dict, steps: int):
        """Greedy generation; returns (tokens (B, steps), per-token seconds)."""
        logits, caches, cur_len = self.prefill(inputs)
        tokens = _greedy_token(logits)
        out = [tokens]
        lat = []
        for _ in range(steps - 1):
            t0 = time.perf_counter()
            logits, caches = self.decode_step(tokens, cur_len, caches)
            lat.append(time.perf_counter() - t0)
            cur_len = cur_len + 1
            tokens = _greedy_token(logits)
            out.append(tokens)
        return torch.cat(out, dim=1), lat

    def generate_paged(self, inputs: dict, steps: int):
        """Greedy generation served from the KV arena — the same tokens as
        :meth:`generate` on the plain path (the gathered page view is as
        wide as the dense cache and masked positions contribute exact
        zeros), but decode reads and writes shared pages instead of
        per-client dense caches. Pages are freed on exit."""
        assert self.arena is not None, "enable_paging first"
        b, t_in = inputs["tokens"].shape
        seq_ids = [("gen", id(inputs), i) for i in range(b)]
        # dense prefill ONCE for the whole batch, then scatter each row's
        # built cache into its pages (copy-on-prefill)
        logits, caches, _ = self.prefill(inputs)
        try:
            for i, sid in enumerate(seq_ids):
                self.arena.alloc(sid, t_in)
                row = {k: tree.map(lambda a: a[:, i : i + 1], v) for k, v in caches.items()}
                self.arena.write_prefill(sid, row, t_in)
            del caches
            tokens = _greedy_token(logits)
            out = [tokens]
            lat = []
            cur = np.full((b,), t_in, np.int64)
            for _ in range(steps - 1):
                t0 = time.perf_counter()
                for sid, c in zip(seq_ids, cur):
                    self.arena.extend(sid, int(c) + 1)  # page for the write position
                bt = self._block_table_for(seq_ids)
                logits = self.paged_decode_step(tokens, cur.astype(np.int32), bt)
                lat.append(time.perf_counter() - t0)
                cur += 1
                tokens = _greedy_token(logits)
                out.append(tokens)
            return torch.cat(out, dim=1), lat
        finally:
            for sid in seq_ids:
                self.arena.free(sid)
