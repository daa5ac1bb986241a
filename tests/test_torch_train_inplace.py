"""The training step in place (``optim/adamw.py: adamw_update_``, a donated
``train_step``, ``TrainLoop``'s ownership of its states) against the
functional step it replaces on a handed-over state, bit for bit, and the
in-place AdamW against the JAX package's update within the tolerance of
``tests/test_torch_train.py::test_adamw_update_matches_jax``."""
import dataclasses
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch import donate, tree  # noqa: E402
from repro_torch.checkpointing import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticTokenPipeline  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_update, adamw_update_, cosine_schedule  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import FailureInjector, TrainLoop  # noqa: E402
from repro_torch.training import train_step as ts  # noqa: E402

CPU = torch.device("cpu")
SHAPE = ShapeConfig("t", 32, 4, "train")
SHAPES = {"stack": (4, 6, 5), "a": (16, 24), "b": {"c": (24,), "d": (3, 8, 5)}, "e": ()}


def random_state(rng, dtype):
    def leaf(s):
        return np.array(rng.standard_normal(s), dtype=np.float32)

    def tree_of(f):
        return jax.tree.map(f, SHAPES, is_leaf=lambda x: isinstance(x, tuple))

    p, g, m = tree_of(leaf), tree_of(lambda s: leaf(s) * 10.0), tree_of(leaf)
    v = tree_of(lambda s: np.abs(leaf(s)) * np.float32(0.1))
    tdt = getattr(torch, dtype)
    as_t = lambda x, dt=torch.float32: torch.tensor(np.asarray(x, np.float32)).to(dt)  # noqa: E731
    state = {"step": torch.tensor(3, dtype=torch.int32), "m": tree.map(as_t, m), "v": tree.map(as_t, v)}
    return (p, g, m, v), tree.map(lambda x: as_t(x, tdt), p), tree.map(lambda x: as_t(x, tdt), g), state


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("piece", [7, 1 << 24])
def test_inplace_adamw_equals_the_functional_update(dtype, piece, monkeypatch):
    """One clipped update at step 4: adamw_update_ writes the functional
    update's params, m, v and step bit for bit into the given tensors, the
    stacked (4, 6, 5) leaf walked in pieces of 7 elements or whole; both
    within test_adamw_update_matches_jax's tolerance of the JAX update."""
    rng = np.random.default_rng(3)
    (p, g, m, v), tp, tg, tstate = random_state(rng, dtype)
    sched = cosine_schedule(1e-2, 2, 10)
    want_p, want_opt, want_met = adamw_update(tp, tg, tstate, AdamWConfig(), sched)
    ptrs = [x.data_ptr() for x in tree.leaves((tp, tstate))]
    monkeypatch.setattr(adamw, "UPDATE_PIECE", piece)
    got_met = adamw_update_(tp, tg, tstate, AdamWConfig(), sched)
    assert [x.data_ptr() for x in tree.leaves((tp, tstate))] == ptrs  # written in place
    assert same_bits(tp, want_p) and same_bits(tstate["m"], want_opt["m"]) and same_bits(tstate["v"], want_opt["v"])
    assert int(tstate["step"]) == 4 and tstate["step"].dtype == torch.int32
    assert all(torch.equal(got_met[k], want_met[k]) for k in ("grad_norm", "lr"))

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jstate = {"step": jnp.int32(3), "m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v)}
    jp, jopt, _ = jax_adamw_update(jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), p),
                                   jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), g), jstate,
                                   JaxAdamWConfig(), jax_cosine(1e-2, 2, 10))
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(jopt[name]), tree.leaves(tstate[name])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6 * float(np.abs(a).max()))
    for a, b in zip(jax.tree.leaves(jp), tree.leaves(tp)):
        if dtype == "float32":
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6 * float(np.abs(a).max()))
        else:  # bf16 bit patterns as integers: adjacent values differ by one
            ja = np.asarray(a).view(np.int16).astype(np.int32)
            assert int(np.abs(ja - b.view(torch.int16).numpy().astype(np.int32)).max(initial=0)) <= 1


def small(microbatches: int = 1):
    cfg = dataclasses.replace(reduced_config(get_arch("llama3.2-1b")), microbatches=microbatches)
    model = build_model(cfg)
    step = ts.make_train_step(model, AdamWConfig(lr=1e-2), cosine_schedule(1e-2, 2, 20))
    data = lambda start: SyntheticTokenPipeline(cfg, SHAPE, seed=7, mode="affine",  # noqa: E731
                                                start_batch=start, device=CPU)
    return cfg, model, step, data


@pytest.mark.parametrize("microbatches", [1, 2])
def test_donated_step_equals_the_functional_step(microbatches, monkeypatch):
    """Two steps on a handed-over state: each returns the input's tensors,
    updated to the functional step's bits (params, m, v, step, every
    metric); no microbatch's gradient tree outlives the step."""
    _, model, step, data = small(microbatches)
    pipe = data(0)
    batches = [next(pipe) for _ in range(2)]
    pipe.close()
    want = ts.init_train_state(model, 0, device=CPU)
    got = tree.map(torch.clone, want)
    grads_seen = []
    real = ts.value_and_grad

    def watched(model_, params, batch):
        loss, metrics, grads = real(model_, params, batch)
        grads_seen.extend(weakref.ref(g) for g in tree.leaves(grads))
        return loss, metrics, grads

    monkeypatch.setattr(ts, "value_and_grad", watched)
    for batch in batches:
        want, want_met = step(want, batch)
        ptrs = [x.data_ptr() for x in tree.leaves(got)]
        grads_seen.clear()
        with donate.donating():
            new, got_met = step(got, batch)
        assert new is got and [x.data_ptr() for x in tree.leaves(new)] == ptrs
        assert len(grads_seen) == microbatches * len(tree.leaves(got["params"]))
        assert all(r() is None for r in grads_seen), "a microbatch's gradient tree outlived the step"
        assert same_bits(got, want)
        assert all(torch.equal(got_met[k], want_met[k]) for k in want_met)
    assert not donate.donated()


def test_loop_donates_only_what_it_owns(tmp_path):
    """Without donation the caller's init_state stays as it was and the
    loop's states after the first step are updated in place; with it,
    init_state itself is the state trained; both end in the same bits."""
    _, model, step, data = small(2)
    init = ts.init_train_state(model, 0, device=CPU)
    keep = tree.map(torch.clone, init)
    seen = []

    def recording(state, batch):
        seen.append((donate.donated(), [x.data_ptr() for x in tree.leaves(state)]))
        return step(state, batch)

    out_a, hist_a = TrainLoop(recording, data, CheckpointManager(str(tmp_path / "a")), ckpt_every=0).run(init, 4)
    assert same_bits(init, keep)
    assert [d for d, _ in seen] == [False, True, True, True]
    assert seen[1][1] == seen[3][1] == [x.data_ptr() for x in tree.leaves(out_a)]
    seen.clear()
    with donate.donating():
        out_b, hist_b = TrainLoop(recording, data, CheckpointManager(str(tmp_path / "b")), ckpt_every=0).run(init, 4)
    assert out_b is init and [d for d, _ in seen] == [True] * 4
    assert same_bits(out_a, out_b) and [h["loss"] for h in hist_a] == [h["loss"] for h in hist_b]


@pytest.mark.parametrize("handed_over", [False, True])
def test_restart_before_the_first_checkpoint_starts_from_init_state(tmp_path, handed_over):
    """A failure at step 2, before the first checkpoint (every 4): the loop
    restarts from init_state as it was (a host copy where init_state was
    handed over and written) and ends equal bit for bit to the run without
    failures; a failure after it (step 6) restores the checkpoint."""
    _, model, step, data = small(2)
    want, _ = TrainLoop(step, data, CheckpointManager(str(tmp_path / "a")), ckpt_every=4).run(
        ts.init_train_state(model, 0, device=CPU), 8)
    init = ts.init_train_state(model, 0, device=CPU)
    keep = tree.map(torch.clone, init)
    loop = TrainLoop(step, data, CheckpointManager(str(tmp_path / "b")), ckpt_every=4)
    injector = FailureInjector([2, 6])
    with donate.donating(handed_over):
        got, _ = loop.run(init, 8, injector)
    assert loop.restarts == 2 and injector.fired == [2, 6]
    assert same_bits(got, want)
    assert same_bits(init, keep) != handed_over  # handed over: written in place


def test_async_checkpoint_holds_its_step_under_in_place_steps(tmp_path):
    """CheckpointManager.save copies the state to the host before it
    returns, so an async save of step 2 holds step 2's bits while the
    donated steps go on writing the same tensors."""
    _, model, step, data = small(1)
    state = ts.init_train_state(model, 0, device=CPU)
    pipe = data(0)
    want = ts.init_train_state(model, 0, device=CPU)
    for _ in range(2):
        want, _ = step(want, next(pipe))
    pipe.close()
    manager = CheckpointManager(str(tmp_path), async_save=True)
    with donate.donating():
        TrainLoop(step, data, manager, ckpt_every=2).run(state, 6)
    assert manager.all_steps() == [2, 4, 6]
    assert same_bits(manager.restore(want, 2), want)


def test_launcher_hands_its_state_to_the_loop(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.train`` keeps no other use for the
    state it builds: its first step already runs donated and writes the
    initial state's own tensors, so the card holds one training state."""
    from repro_torch.launch import train

    real_init, real_make = ts.init_train_state, ts.make_train_step
    made, seen = [], []

    def init(*args, **kw):
        made.append(real_init(*args, **kw))
        return made[-1]

    def make(*args, **kw):
        step = real_make(*args, **kw)

        def recording(state, batch):
            seen.append((donate.donated(), [x.data_ptr() for x in tree.leaves(state)]))
            new, metrics = step(state, batch)
            assert new is state  # updated in place
            return new, metrics
        return recording

    monkeypatch.setattr(ts, "init_train_state", init)
    monkeypatch.setattr(ts, "make_train_step", make)
    train.main(["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                "--ckpt-every", "0", "--ckpt-dir", str(tmp_path)])
    assert [d for d, _ in seen] == [True] * 3
    assert len(made) == 1 and all(ptrs == [x.data_ptr() for x in tree.leaves(made[0])] for _, ptrs in seen)
    assert not donate.donated()
