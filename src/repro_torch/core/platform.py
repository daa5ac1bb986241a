"""Provuse platform: deploy / invoke / observe / fuse.

:class:`TinyTorchBackend` is the tinyFaaS analogue and the counterpart of
the JAX package's ``TinyJaxBackend``: a minimal in-process dispatcher.
Invocations execute in the calling thread; routing is a dict lookup; async
branches run on a small shared pool. The Function Handler, Merger, policy,
control plane and billing meter are backend-agnostic, as the paper shows.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch

from repro_torch.core.billing import BillingMeter
from repro_torch.core.context import AbstractContext
from repro_torch.core.errors import DeploymentError, InvocationError, UnknownFunctionError
from repro_torch.core.function import FunctionInstance, FunctionSpec, _struct_key, _structs_of
from repro_torch.core.handler import FunctionHandler
from repro_torch.core.lifecycle import ControlPlane
from repro_torch.core.merger import Merger
from repro_torch.core.policy import FusionPolicy
from repro_torch.core.registry import RoutingTable
from repro_torch.scheduler.clock import SYSTEM_CLOCK


class ProvusePlatform:
    """Base platform. ``invoke`` is the paper's serial path: one request,
    executed to completion in (or via) the calling thread."""

    backend_name = "base"

    GUARDED_FIELDS = {"_pending_candidates": "_pending_lock"}

    def __init__(self, policy: FusionPolicy | None = None, *, async_build: bool = False,
                 health_rtol: float = 2e-2, health_atol: float = 1e-2, clock=None):
        self.clock = clock or SYSTEM_CLOCK
        self.registry = RoutingTable()
        self.meter = BillingMeter(clock=self.clock)
        self.policy = policy or FusionPolicy()
        self.handler = FunctionHandler(self.meter, on_fusion_candidate=self._on_candidate,
                                       clock=self.clock)
        # Control plane: every deploy/merge/redeploy is an epoch transition
        # published through here.
        self.lifecycle = ControlPlane(self, self.registry, clock=self.clock)
        self.merger = Merger(self, self.policy, async_build=async_build,
                             health_rtol=health_rtol, health_atol=health_atol)
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
        """External (client) invocation — serial path."""
        self.handler.record_canary(name, args)
        t0 = self.clock.now()
        out = self._invoke_with_retry(name, args)
        self.meter.observe_latency(name, self.clock.now() - t0)
        return out

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
        t0 = self.clock.now()
        out = self._dispatch_sync(callee, args)
        wait = self.clock.now() - t0
        self.handler.attribute_blocked(wait)
        self.handler.observe_edge(caller_fn, callee, sync=True, wait_s=wait)
        return out

    def async_call(self, caller_instance: FunctionInstance, caller_fn: str, callee: str, args: tuple) -> None:
        self.handler.observe_edge(caller_fn, callee, sync=False)
        self._dispatch_async(callee, args)

    # ------------------------------------------------------------- metrics

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
        }

    # ------------------------------------------------------------- backend API

    def _dispatch_sync(self, name: str, args: tuple):
        raise NotImplementedError

    def _dispatch_async(self, name: str, args: tuple) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        self.merger.wait_idle()


class TinyTorchBackend(ProvusePlatform):
    """tinyFaaS analogue: direct in-thread dispatch, minimal overhead."""

    backend_name = "tinytorch"

    def __init__(self, *args, async_workers: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self._async_pool = ThreadPoolExecutor(max_workers=async_workers, thread_name_prefix="tinytorch-async")

    def _dispatch_sync(self, name: str, args: tuple):
        instance = self.registry.resolve(name)
        return self._run_request(instance, name, args)

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
