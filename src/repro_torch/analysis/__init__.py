"""provlint for the port: the JAX package's static passes (lock
discipline, lock order, clock hygiene, test sleeps), copied with only their
imports changed, run over ``src/repro_torch`` and ``tests/test_torch_*.py``
by ``python -m repro_torch.analysis.lint``. The dispatch tracer
(``repro/analysis/dispatch.py``) is not ported yet."""
