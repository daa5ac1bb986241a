"""Serving engine: deploys a model on the Provuse platform as a FaaS
function *chain* and serves prefill/decode through it.

Chain layout (dense family):

    <arch>/embed  ->  <arch>/g0  ->  ...  ->  <arch>/g{G-1}  ->  <arch>/head

Each stage is an independently deployed function holding its own layer-slice
weights; every stage synchronously calls the next and returns the final
result back up the chain — while the head computes, every upstream instance
is blocked (the paper's double-billing chain).

The platform observes the synchronous edges during live traffic and fuses
the chain step by step into a single unit per request type — no code here
ever asks for fusion; it *happens to* the deployment (transparent,
platform-side). Per-token latency before/after is the paper's Fig. 5.

Stage functions are shape-polymorphic: a (B, T>1) input takes the prefill
path (and fills the preallocated max_len cache); (B, 1) takes the decode
path. One deployed function serves both request types. Caches are never
written in place: every stage returns new cache tensors.
"""
from __future__ import annotations

import time

import torch

from repro_torch import tree
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.function import FunctionSpec
from repro_torch.core.platform import ProvusePlatform
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, embed_tokens, unembed
from repro_torch.models.model import Model
from repro_torch.models.params import init_params


def _greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling on the device: (B, V) logits -> (B, 1) int32 tokens."""
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


def _slice_tree(t, lo: int, hi: int):
    return tree.map(lambda x: x[lo:hi], t)


def _pick_groups(n_layers: int, requested: int) -> int:
    g = min(requested, n_layers)
    while g > 1 and n_layers % g:
        g -= 1
    return max(1, g)


class ServingEngine:
    def __init__(self, model: Model, platform: ProvusePlatform, *, max_len: int = 256,
                 params=None, trust_domain: str | None = None, device=None, seed: int = 0):
        self.model = model
        self.cfg = model.cfg
        self.platform = platform
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = params if params is not None else model.init(seed, device=self.device)
        self.prefix = self.cfg.name
        self.trust = trust_domain or self.cfg.name
        self.entry = f"{self.prefix}/embed"
        self._deploy_blocks_chain()

    # ------------------------------------------------------------ chain

    def _deploy_blocks_chain(self) -> None:
        cfg = self.cfg
        L = cfg.num_layers
        g = _pick_groups(L, cfg.num_function_groups)
        per = L // g
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
                old = caches[key]
                if x.shape[1] == 1:  # decode
                    h, new_cache = tfm.apply_stack_decode(params, x, old, cfg, cur_len)
                else:  # prefill: build the cache and place it in the max_len slots
                    positions = torch.arange(x.shape[1], device=x.device)[None, :]
                    h, built = tfm.apply_stack_full(params, x, cfg, positions, collect_cache=True)
                    new_cache = {}
                    for name, full in old.items():
                        filled = full.clone()
                        filled[:, :, : x.shape[1]] = built[name].to(full.dtype)
                        new_cache[name] = filled
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
            h = apply_norm(params["ln_f"], x[:, -1:], cfg)
            return unembed(params["embed"], h)[:, 0], caches

        self.platform.deploy(
            FunctionSpec(head_name, head_fn, {"ln_f": self.params["ln_f"], "embed": self.params["embed"]}, self.trust)
        )
        self.group_names = names

    def chain_names(self) -> list[str]:
        """Every function name this engine deployed, in chain order."""
        return [self.entry, *self.group_names, f"{self.prefix}/head"]

    # ------------------------------------------------------------ caches

    def empty_caches(self, batch: int):
        """Zeroed max_len caches, re-keyed by chain stage."""
        shape = ShapeConfig("serve", self.max_len, batch, "decode")
        cache = init_params(self.model.cache_defs(shape), device=self.device)
        g = len(self.group_names)
        per = self.cfg.num_layers // g
        return {f"g{i}": _slice_tree(cache, i * per, (i + 1) * per) for i in range(g)}

    # ------------------------------------------------------------ serving API

    def prefill(self, inputs: dict, caches=None):
        b, t_in = inputs["tokens"].shape
        if caches is None:
            caches = self.empty_caches(b)
        cur_len = torch.full((b,), t_in, dtype=torch.int32, device=self.device)
        logits, caches = self.platform.invoke(self.entry, inputs, cur_len, caches)
        return logits, caches, cur_len

    def decode_step(self, tokens, cur_len, caches):
        return self.platform.invoke(self.entry, {"tokens": tokens}, cur_len, caches)

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
