"""Provuse platform: deploy / invoke / observe / fuse.

Two external invocation paths, as in the JAX package:

* ``invoke`` — the paper's serial path: one request executed to completion
  in (or via) the calling thread.
* ``invoke_async`` — returns a Future; the request scheduler coalesces
  concurrent compatible requests into micro-batches that run as one
  batched program (``FunctionInstance.execute_batch``).

:class:`TinyTorchBackend` is the tinyFaaS analogue and the counterpart of
the JAX package's ``TinyJaxBackend``: a minimal in-process dispatcher.
Invocations execute in the calling thread; routing is a dict lookup; async
branches run on a small shared pool. The Function Handler, Merger, policy,
control plane and billing meter are backend-agnostic, as the paper shows.
"""
from __future__ import annotations

import contextlib
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import torch

from repro_torch.core.billing import BillingMeter, ProvisioningRecord
from repro_torch.core.context import AbstractContext
from repro_torch.core.errors import DeploymentError, InvocationError, UnknownFunctionError
from repro_torch.core.function import FunctionInstance, FunctionSpec, _struct_key, _structs_of
from repro_torch.core.handler import FunctionHandler
from repro_torch.core.lifecycle import ControlPlane
from repro_torch.core.merger import Merger
from repro_torch.core.policy import FusionPolicy
from repro_torch.core.registry import RoutingTable
from repro_torch.obs.critical_path import EdgeCostModel
from repro_torch.obs.trace import Tracer
from repro_torch.scheduler.clock import SYSTEM_CLOCK
from repro_torch.scheduler.scheduler import RequestScheduler
from repro_torch.scheduler.slo import SLOClass


class ProvusePlatform:
    """Base platform: ``invoke`` (serial) and ``invoke_async`` (scheduled,
    micro-batched)."""

    backend_name = "base"

    GUARDED_FIELDS = {"_pending_candidates": "_pending_lock"}

    def __init__(self, policy: FusionPolicy | None = None, *, async_build: bool = False,
                 health_rtol: float = 2e-2, health_atol: float = 1e-2,
                 max_batch: int = 8, max_delay_ms: float = 2.0,
                 adaptive: bool = False, adaptive_config=None,
                 be_shed_depth: int | None = None, clock=None, tracing: bool = True):
        self.clock = clock or SYSTEM_CLOCK
        # Always-on causal tracing: every entry point mints a SpanContext,
        # every phase lands in the tracer's flight recorder, and the
        # EdgeCostModel turns measured sync waits / merge stalls into the
        # policy's cost inputs. ``tracing=False`` disables span minting
        # (the overhead-gate baseline) without touching any call site.
        self.tracer = Tracer(clock=self.clock, enabled=tracing)
        self.edge_costs = EdgeCostModel()
        self.registry = RoutingTable()
        self.meter = BillingMeter(clock=self.clock)
        self.policy = policy or FusionPolicy()
        if self.policy.cost_model is None:
            self.policy.cost_model = self.edge_costs
        self.handler = FunctionHandler(self.meter, on_fusion_candidate=self._on_candidate,
                                       clock=self.clock, tracer=self.tracer)
        # Control plane: every deploy/merge/redeploy is an epoch transition
        # published through here.
        self.lifecycle = ControlPlane(self, self.registry, clock=self.clock)
        self.merger = Merger(self, self.policy, async_build=async_build,
                             health_rtol=health_rtol, health_atol=health_atol)
        self.scheduler = RequestScheduler(
            self._dispatch_batch, max_batch=max_batch, max_delay_ms=max_delay_ms,
            adaptive=adaptive, adaptive_config=adaptive_config,
            be_shed_depth=be_shed_depth,
            on_request_done=lambda name, lat_s, k: self.meter.observe_latency(name, lat_s),
            clock=self.clock,
            tracer=self.tracer,
        )
        self._specs: dict[str, FunctionSpec] = {}
        self._shape_cache: dict[tuple, Any] = {}
        self._shape_stack: list[str] = []
        self._shape_lock = threading.RLock()
        # Fusion candidates are processed OFF the data path: an edge observed
        # mid-request is queued and the merge runs after the request
        # completes — control-plane work does not belong on the request path.
        self._pending_candidates: list[tuple[str, str]] = []
        self._pending_lock = threading.Lock()
        self._draining = threading.Lock()

    # ------------------------------------------------------------- deploy

    def deploy(self, spec: FunctionSpec) -> FunctionInstance:
        if spec.name in self._specs:
            raise DeploymentError(f"function {spec.name!r} already deployed")
        self._specs[spec.name] = spec
        instance = FunctionInstance({spec.name: spec}, self)
        self.attach_instance(instance)
        instance.mark_ready()
        self.lifecycle.publish({spec.name: instance}, kind="deploy", reason="deploy")
        return instance

    def spec_of(self, name: str) -> FunctionSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise UnknownFunctionError(name) from None

    # ------------------------------------------------------------- shapes

    def output_structs(self, name: str, args: tuple):
        """Output signature (meta tensors) of ``name`` called with ``args``'s
        shapes and dtypes — computed by running the function on meta
        tensors, nested calls resolved recursively; nothing is executed."""
        key = (name, _struct_key(args))
        with self._shape_lock:
            if key in self._shape_cache:
                return self._shape_cache[key]
            if name in self._shape_stack:
                raise InvocationError(f"call cycle through {name!r}: {self._shape_stack}")
            spec = self.spec_of(name)
            self._shape_stack.append(name)
            try:
                with torch.no_grad():
                    out = spec.fn(AbstractContext(self, name), _structs_of(spec.params), *_structs_of(args))
            finally:
                self._shape_stack.pop()
            self._shape_cache[key] = out
            return out

    # ------------------------------------------------------------- hooks

    def _on_candidate(self, caller: str, callee: str) -> None:
        with self._pending_lock:
            if (caller, callee) not in self._pending_candidates:
                self._pending_candidates.append((caller, callee))

    def _drain_candidates(self) -> None:
        if not self._draining.acquire(blocking=False):
            return  # a merge in progress is already invoking health checks
        try:
            # a merge's canary replays are control-plane traffic: they run
            # outside the trace of the request that happened to trigger it
            # (the merge shows on the control timeline instead)
            with _outside_traces(self.tracer):
                while True:
                    with self._pending_lock:
                        if not self._pending_candidates:
                            return
                        caller, callee = self._pending_candidates.pop(0)
                    self.merger.submit(caller, callee)
        finally:
            self._draining.release()

    def attach_instance(self, instance: FunctionInstance) -> None:
        """Backend hook: provision execution resources for an instance."""

    def detach_instance(self, instance: FunctionInstance) -> None:
        """Backend hook: tear down resources for a never-promoted instance."""

    def retire_instance(self, instance: FunctionInstance) -> int:
        freed = instance.retire()
        self.detach_instance(instance)
        return freed

    # ------------------------------------------------------------- running

    def _run_request(self, instance: FunctionInstance, entry: str, args: tuple):
        instance.begin_request()
        self.handler.enter(entry, instance)
        try:
            out = instance.execute(entry, args)
        except BaseException:
            # failed attempts are not billed — the retry path would otherwise
            # double-bill the same request (swap races, redeploys)
            self.handler.abort(entry)
            raise
        else:
            self.handler.exit(entry)
            return out
        finally:
            instance.end_request()

    def _run_batch(self, instance: FunctionInstance, entry: str, args_list: list[tuple]) -> list:
        instance.begin_request()
        self.handler.enter(entry, instance, batch_size=len(args_list))
        try:
            out = instance.execute_batch(entry, args_list, max_bucket=self.scheduler.max_batch)
        except BaseException:
            self.handler.abort(entry)
            raise
        else:
            self.handler.exit(entry)
            return out
        finally:
            instance.end_request()

    def _invoke_with_retry(self, name: str, args: tuple):
        """Serial dispatch with swap-race recovery. Also the Merger's canary
        replay path — no latency observation here, so control-plane traffic
        never pollutes the external latency percentiles."""
        try:
            try:
                return self._dispatch_sync(name, args)
            except InvocationError:
                # A request can race a merge swap: it resolved the old
                # instance, the Merger retired it mid-flight. Re-resolving
                # picks up the new routing; only if THAT fails is the
                # container actually gone and a fresh one provisioned.
                try:
                    return self._dispatch_sync(name, args)
                except InvocationError:
                    self._redeploy(name)
                    return self._dispatch_sync(name, args)
        finally:
            self._drain_candidates()

    def invoke(self, name: str, *args):
        """External (client) invocation — serial path. Mints the request's
        trace and activates it so every phase below (execute, cross-function
        hops) nests under this root."""
        self.handler.record_canary(name, args)
        self.handler.note_demand(name)
        t0 = self.clock.now()
        ctx = self.tracer.begin_request(name, "invoke", t0=t0)
        try:
            with self.tracer.activate(ctx):
                out = self._invoke_with_retry(name, args)
        except BaseException as exc:
            if ctx is not None:
                ctx.finish(args={"error": type(exc).__name__})
            raise
        t1 = self.clock.now()
        if ctx is not None:
            ctx.finish(t1)
        self.meter.observe_latency(name, t1 - t0)
        return out

    def invoke_async(self, name: str, *args, priority: int = 0,
                     slo: SLOClass | None = None) -> Future:
        """External invocation through the request scheduler. Returns a
        Future; compatible concurrent requests may execute as one batch.
        ``slo=SLOClass(name, target_p95_ms)`` admits the request into its
        class's own lane (single-class batches, window from the class's
        target slack); ``priority=PRIORITY_HIGH`` is the two-level shim —
        it maps to the zero-target class, jumps queued normal traffic, and
        closes an open batching window early (SLO admission)."""
        self.handler.record_canary(name, args)
        self.handler.note_demand(name)
        return self.scheduler.submit(name, args, priority=priority, slo=slo)

    def scheduler_signals(self, names):
        """Live scheduler feedback for the fusion policy (Merger.submit)."""
        return self.scheduler.signals_for(names)

    def _dispatch_batch(self, name: str, args_list: list[tuple]) -> list:
        """Scheduler callback: execute one coalesced batch."""
        try:
            try:
                return self._dispatch_batch_impl(name, args_list)
            except InvocationError:
                try:  # routing may have swapped mid-flight (see invoke)
                    return self._dispatch_batch_impl(name, args_list)
                except InvocationError:
                    self._redeploy(name)
                    return self._dispatch_batch_impl(name, args_list)
        finally:
            self._drain_candidates()

    def _redeploy(self, name: str) -> None:
        spec = self.spec_of(name)
        fresh = FunctionInstance({name: spec}, self)
        self.attach_instance(fresh)
        fresh.mark_ready()
        # Epoch transition: the displaced (dead-routed) instance is drained
        # AND retired.
        self.lifecycle.publish({name: fresh}, kind="redeploy", reason=f"redeploy {name}")

    def remote_call(self, caller_instance: FunctionInstance, caller_fn: str, callee: str, args: tuple):
        """Blocking function-to-function dispatch from eager glue: the caller
        is parked until this returns, and the wait is the observed sync edge."""
        self.handler.record_canary(callee, args)
        # Boundary hop: the wait is a distinct "cross-function-sync" span in
        # the caller's trace (a fused-inline call records no hop — see
        # EagerContext.call), and the measured wait feeds the edge-cost EWMA
        # the fusion policy weighs instead of its static knobs.
        cur = self.tracer.current()
        sid = cur[0].alloc_id() if cur is not None else None
        t0 = self.clock.now()
        with self.tracer.activate(cur[0] if cur else None, sid or 1):
            out = self._dispatch_sync(callee, args)
        wait = self.clock.now() - t0
        if cur is not None:
            cur[0].emit(f"{caller_fn}->{callee}", "cross-function-sync",
                        t0, t0 + wait, parent_id=cur[1], span_id=sid,
                        args={"caller": caller_fn, "callee": callee})
        self.handler.attribute_blocked(wait)
        self.handler.observe_edge(caller_fn, callee, sync=True, wait_s=wait)
        self.edge_costs.observe_sync_edge(caller_fn, callee, wait)
        return out

    def async_call(self, caller_instance: FunctionInstance, caller_fn: str, callee: str, args: tuple) -> None:
        self.handler.observe_edge(caller_fn, callee, sync=False)
        self._dispatch_async(callee, args)

    # ------------------------------------------------------------- metrics

    def note_provisioning(self, kind: str, seconds: float, *, warm: bool,
                          functions=(), resident_bytes: int = 0) -> None:
        """Record one provisioning transition (here: a merge) with its
        warm-vs-cold classification on the billing meter, as a span ending
        now on the control-plane timeline, and — for a merge — as a sample
        of the measured merge stall the policy's cost model weighs."""
        rec = ProvisioningRecord(
            kind=kind, functions=tuple(functions), seconds=float(seconds),
            resident_bytes=int(resident_bytes), warm=bool(warm),
        )
        self.meter.record_provisioning(rec)
        t1 = self.clock.now()
        self.tracer.control_span(
            f"{kind}:{'+'.join(rec.functions) or '?'}", t1 - rec.seconds, t1,
            args={"kind": kind, "warm": rec.warm, "billed": rec.billed,
                  "seconds": rec.seconds})
        if kind == "merge":
            # the queue depth the stall was inflicted on rides along: the
            # measured replacement for the static saturation_penalty
            depth = self.scheduler.signals_for(rec.functions).queue_depth
            self.edge_costs.observe_merge_stall(rec.seconds, depth)

    def ram_bytes(self) -> int:
        return sum(inst.resident_bytes() for inst in self.registry.live_instances())

    def stats(self) -> dict:
        meter_snap = self.meter.snapshot()
        return {
            "backend": self.backend_name,
            "ram_bytes": self.ram_bytes(),
            "instances": [repr(i) for i in self.registry.live_instances()],
            "edges": self.handler.stats(),
            "merges": [
                {
                    "members": e.members,
                    "freed_bytes": e.freed_bytes,
                    "build_s": round(e.build_s, 4),
                    "healthy": e.healthy,
                    "epoch": e.epoch,
                    "reason": e.reason,
                }
                for e in self.merger.merge_log
            ],
            "lifecycle": self.lifecycle.stats(),
            "billing": meter_snap["billing"],
            "latency": meter_snap["latency"],
            "scheduler": self.scheduler.stats(),
            "batching": self.batching_stats(),
            "edge_costs": self.edge_costs.stats(),
        }

    def batching_stats(self) -> dict:
        """Per live instance: the requests that ran per request because
        their entry cannot be one batched program, and why."""
        return {inst.instance_id: inst.batch_stats() for inst in self.registry.live_instances()}

    # ------------------------------------------------------------- backend API

    def _dispatch_sync(self, name: str, args: tuple):
        raise NotImplementedError

    def _dispatch_async(self, name: str, args: tuple) -> None:
        raise NotImplementedError

    def _dispatch_batch_impl(self, name: str, args_list: list[tuple]) -> list:
        raise NotImplementedError

    def shutdown(self) -> None:
        self.merger.wait_idle()
        self.scheduler.shutdown()


class TinyTorchBackend(ProvusePlatform):
    """tinyFaaS analogue: direct in-thread dispatch, minimal overhead."""

    backend_name = "tinytorch"

    def __init__(self, *args, async_workers: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self._async_pool = ThreadPoolExecutor(max_workers=async_workers, thread_name_prefix="tinytorch-async")

    def _dispatch_sync(self, name: str, args: tuple):
        instance = self.registry.resolve(name)
        return self._run_request(instance, name, args)

    def _dispatch_batch_impl(self, name: str, args_list: list[tuple]) -> list:
        instance = self.registry.resolve(name)
        return self._run_batch(instance, name, args_list)

    def _dispatch_async(self, name: str, args: tuple) -> None:
        self._async_pool.submit(self._safe_async, name, args)

    def _safe_async(self, name: str, args: tuple) -> None:
        try:
            self._dispatch_sync(name, args)
        except Exception:
            pass  # async branches are fire-and-forget; failures show as billing absence

    def shutdown(self) -> None:
        super().shutdown()
        self._async_pool.shutdown(wait=True)


@contextlib.contextmanager
def _outside_traces(tracer):
    """Run the block with no trace active on this thread, then restore the
    thread's activations as they were."""
    held = []
    while (cur := tracer.current()) is not None:
        held.append(cur)
        tracer.pop()
    try:
        yield
    finally:
        for ctx, parent in reversed(held):
            tracer.push(ctx, parent)
