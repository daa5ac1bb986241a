"""Deterministic synthetic token pipeline with background prefetch (the JAX
package's ``data/pipeline.py``).

Two modes:
* ``affine`` — next token = (31 * tok + 7) % vocab: a *learnable* stream, so
  a training run shows the loss falling;
* ``random`` — i.i.d. tokens (throughput runs; the loss floor is ln V).

Determinism: batch ``i`` depends only on (seed, i), drawn with the
reference's numpy generator in the reference's order, so a batch equals the
JAX package's bit for bit and a restarted job resumes mid-stream with the
same data. A producer thread makes host batches ahead of the consumer (at
most ``prefetch``); ``next`` places one on ``device`` (default: the card).
With ``mesh`` and ``rules``, every rank makes the same host batch and
places its shard of each leaf as a ``DTensor`` with the strict placements
of the leaf's logical axes (the reference's ``to_named_sharding``).
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device

JOIN_S = 10.0  # close() waits this long for the producer thread


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(name -> (shape, dtype, logical)) for the train batch of this arch.
    The stub frontend embeddings are drawn in float32 and stay float32 on
    the way to the device, as the reference's unsharded placement leaves
    them; the model casts them to its own dtype."""
    b, t = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return {
            "src_embeds": ((b, t, cfg.d_model), torch.float32, ("batch", "seq", None)),
            "tgt_tokens": ((b, t), torch.int32, ("batch", "seq")),
            "targets": ((b, t), torch.int32, ("batch", "seq")),
        }
    if cfg.family == "vlm":
        return {
            "embeds": ((b, t, cfg.d_model), torch.float32, ("batch", "seq", None)),
            "targets": ((b, t), torch.int32, ("batch", "seq")),
        }
    return {
        "tokens": ((b, t), torch.int32, ("batch", "seq")),
        "targets": ((b, t), torch.int32, ("batch", "seq")),
    }


class SyntheticTokenPipeline:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeConfig,
        *,
        seed: int = 0,
        mode: str = "affine",
        prefetch: int = 2,
        start_batch: int = 0,
        device=None,
        mesh=None,
        rules=None,
    ):
        self.cfg, self.shape = cfg, shape
        self.mesh, self.rules = mesh, rules
        self.seed, self.mode = seed, mode
        self.device = resolve_device(device)
        self.index = start_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # ----------------------------------------------------------- generation

    def _host_batch(self, index: int) -> dict[str, np.ndarray]:
        b, t = self.shape.global_batch, self.shape.seq_len
        v = max(2, self.cfg.vocab_size)
        rng = np.random.default_rng((self.seed, index))
        if self.mode == "affine":
            first = rng.integers(0, v, size=(b, 1), dtype=np.int64)
            seq = [first]
            for _ in range(t):
                seq.append((31 * seq[-1] + 7) % v)
            stream = np.concatenate(seq, axis=1)  # (b, t+1)
        else:
            stream = rng.integers(0, v, size=(b, t + 1), dtype=np.int64)
        tokens = stream[:, :t].astype(np.int32)
        targets = stream[:, 1:].astype(np.int32)
        out: dict[str, np.ndarray] = {}
        for name, (shp, _, _) in make_batch_specs(self.cfg, self.shape).items():
            if name in ("tokens", "tgt_tokens"):
                out[name] = tokens
            elif name == "targets":
                out[name] = targets
            else:  # stub frontend embeddings, derived deterministically
                out[name] = rng.standard_normal(size=shp).astype(np.float32) * 0.02
        return out

    def _place(self, host: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        if self.mesh is None or self.rules is None:
            return {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        from repro_torch.sharding import spmd
        from repro_torch.sharding.specs import to_named_sharding

        specs = make_batch_specs(self.cfg, self.shape)
        return {k: spmd.distribute(torch.from_numpy(v).to(self.device), self.mesh,
                                   to_named_sharding(self.mesh, specs[k][0], specs[k][2], self.rules))
                for k, v in host.items()}

    def _producer(self):
        while not self._stop.is_set():
            batch = self._host_batch(self.index)
            self.index += 1
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.25)
                    break
                except queue.Full:
                    continue

    # ----------------------------------------------------------- iteration

    def __iter__(self):
        return self

    def __next__(self):
        return self._place(self._q.get())

    def close(self):
        """Stop the producer, drop what it made ahead, and wait for its
        thread (it exits within one batch's making)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(JOIN_S)
