"""Concurrent request scheduling: admission queues + micro-batched dispatch.

A copy of the JAX package's scheduler, tracer hooks included: per-(function,
shape, SLO-class) admission lanes whose coalescers hand micro-batches to the
platform's batched dispatch (``ProvusePlatform.invoke_async``), windows set
by the queueing model, an injectable clock that makes every timing behavior
testable on a deterministic virtual clock, the shared service-time estimate
and SLO class lanes the continuous batcher uses.
"""
