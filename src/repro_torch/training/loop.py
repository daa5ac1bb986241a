"""Fault-tolerant training loop: checkpoint/restart, failure injection,
straggler monitoring (the JAX package's ``training/loop.py``).

Failure model:
* process crash / node loss  -> restart from the latest atomic checkpoint
  (exercised by :class:`FailureInjector`, which raises at configured steps;
  the loop restores and continues, and with the deterministic pipeline the
  run ends with the same params bit for bit);
* stragglers                 -> per-step wall times are tracked; steps
  slower than ``straggler_factor`` x the trailing median are recorded as
  :class:`StragglerEvent`\\ s.

A step's clock stops after a device sync on its metrics (the reference's
``jax.block_until_ready``). There is no ``jit_step``: the port runs eagerly.

State ownership (the reference's jit donates the state to each step): every
state a step returns belongs to the loop, so each later step runs inside
:func:`repro_torch.donate.donating` and updates it in place. The caller's
``init_state`` is written only when the caller hands it over, by calling
:meth:`TrainLoop.run` inside ``donating()``; then, when a
:class:`FailureInjector` may send the loop back to it, the loop first keeps
a host copy to restart from. Otherwise the first step is functional and
``init_state`` stays as it was.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

import torch

from repro_torch import donate, tree
from repro_torch.checkpointing.manager import CheckpointManager


class InjectedFailure(RuntimeError):
    pass


class FailureInjector:
    """Raises InjectedFailure the first time each configured step is reached."""

    def __init__(self, fail_at_steps: list[int]):
        self.pending = set(fail_at_steps)
        self.fired: list[int] = []

    def maybe_fail(self, step: int) -> None:
        if step in self.pending:
            self.pending.discard(step)
            self.fired.append(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerEvent:
    step: int
    seconds: float
    median_seconds: float


def _block_until_ready(metrics: dict) -> None:
    """Wait for every CUDA device that holds one of ``metrics``."""
    for dev in {v.device for v in metrics.values() if isinstance(v, torch.Tensor) and v.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class TrainLoop:
    def __init__(
        self,
        train_step: Callable,
        make_data: Callable[[int], Any],
        manager: CheckpointManager,
        *,
        ckpt_every: int = 50,
        straggler_factor: float = 3.0,
        window: int = 20,
    ):
        """``make_data(start_batch)`` returns an iterator positioned at that
        batch (restart resumes the stream exactly where it crashed)."""
        self.train_step = train_step
        self.make_data = make_data
        self.manager = manager
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.window = window
        self.straggler_events: list[StragglerEvent] = []
        self.restarts = 0

    def run(self, init_state, num_steps: int, failure_injector: FailureInjector | None = None):
        """Steps from the latest checkpoint (else from ``init_state``) to
        ``num_steps``; returns (final state, history). Inside
        ``donate.donating()`` ``init_state`` is handed over and may be
        updated in place."""
        history: list[dict] = []
        step_times: list[float] = []
        handed_over = donate.donated()
        # what a restart with no checkpoint goes back to: init_state itself,
        # or a host copy when the loop may write init_state in place
        host_init = (tree.map(lambda x: x.detach().to("cpu", copy=True), init_state)
                     if handed_over and failure_injector is not None else None)

        def from_init():
            if host_init is None:
                return init_state, handed_over
            return tree.map(lambda h, like: h.to(like.device, copy=True), host_init, init_state), True

        latest = self.manager.latest_step()
        if latest is not None:
            state, owned = self.manager.restore(init_state, latest), True
            step = latest
        else:
            state, owned = init_state, handed_over
            step = 0
        data = self.make_data(step)

        while step < num_steps:
            try:
                batch = next(data)
                if failure_injector is not None:
                    failure_injector.maybe_fail(step)
                t0 = time.perf_counter()
                with donate.donating(owned):
                    state, metrics = self.train_step(state, batch)
                owned = True
                _block_until_ready(metrics)
                dt = time.perf_counter() - t0
                step += 1
                step_times.append(dt)
                if len(step_times) > 3:
                    med = statistics.median(step_times[-self.window :])
                    if dt > self.straggler_factor * med:
                        self.straggler_events.append(StragglerEvent(step, dt, med))
                history.append({"step": step, "seconds": dt, **{k: float(v) for k, v in metrics.items()}})
                if self.ckpt_every and step % self.ckpt_every == 0:
                    self.manager.save(step, state)
            except InjectedFailure:
                # simulated crash: drop in-memory state, restore, reposition data
                self.restarts += 1
                if hasattr(data, "close"):
                    data.close()
                latest = self.manager.latest_step()
                state = None  # the crashed state, before its replacement is allocated
                if latest is None:
                    state, owned = from_init()
                    step = 0
                else:
                    state, owned = self.manager.restore(init_state, latest), True
                    step = latest
                data = self.make_data(step)
        self.manager.wait()
        if hasattr(data, "close"):
            data.close()
        return state, history
