"""The port's CheckpointManager (``repro_torch.checkpointing``): the cases of
the JAX package's ``tests/test_checkpoint.py`` (round trip with bf16,
retention, no ``.tmp`` left, a missing step, async save, async failure
surfacing), on state made by the JAX package and carried across, and the
format shared with the reference: a checkpoint the JAX manager writes
restores into the port bit for bit, and one the port writes restores into
the JAX manager bit for bit."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing import CheckpointManager as RefManager  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.checkpointing import CheckpointManager, CheckpointSaveError  # noqa: E402


def jax_state(seed=0):
    """tests/test_checkpoint.py's state: a bf16 matrix, an fp32 vector, a
    0-d int32 step and an fp32 matrix."""
    k = jax.random.PRNGKey(seed)
    return {
        "params": {
            "w": jax.random.normal(k, (8, 16)).astype(jnp.bfloat16),
            "b": jnp.arange(16, dtype=jnp.float32),
        },
        "opt": {"step": jnp.int32(7), "m": jnp.ones((8, 16), jnp.float32)},
    }


def to_torch(x):
    """A JAX leaf as a torch tensor of the same dtype and bits (bf16
    through its uint16 view)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def make_state(seed=0):
    return jax.tree.map(to_torch, jax_state(seed))


def bits(x) -> np.ndarray:
    """The raw bytes of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().reshape(-1).view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


def assert_tree_equal(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip_exact_including_bf16(tmp_path):
    m = CheckpointManager(str(tmp_path))
    state = make_state()
    m.save(3, state)
    restored = m.restore(state, 3)
    assert_tree_equal(state, restored)


def test_latest_and_retention(tmp_path):
    m = CheckpointManager(str(tmp_path), retain=2)
    state = make_state()
    for s in (1, 2, 3, 4):
        m.save(s, state)
    assert m.latest_step() == 4
    assert m.all_steps() == [3, 4]  # older ones pruned


def test_no_tmp_dirs_left_behind(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, make_state())
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_restore_missing_raises(tmp_path):
    m = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        m.restore(make_state())


def test_async_save_then_restore(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=True)
    state = make_state()
    m.save(10, state)
    m.wait()
    assert m.latest_step() == 10
    assert_tree_equal(state, m.restore(state, 10))


def test_async_save_snapshots_the_state_it_was_given(tmp_path):
    """The async save copies the leaves before the step moves on: a change
    made to the state after save() is not in the checkpoint."""
    m = CheckpointManager(str(tmp_path), async_save=True)
    state = make_state()
    want = tree.map(torch.clone, state)
    m.save(1, state)
    state["opt"]["m"].add_(1.0)
    m.wait()
    assert_tree_equal(want, m.restore(want, 1))


def test_restore_into_structs(tmp_path):
    """Elastic restore: the 'like' tree can be meta tensors (a fresh job that
    never materialized params), given the device to restore onto."""
    m = CheckpointManager(str(tmp_path))
    state = make_state()
    m.save(2, state)
    like = tree.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), state)
    with pytest.raises(ValueError, match="meta"):
        m.restore(like, 2)
    assert_tree_equal(state, m.restore(like, 2, device="cpu"))


# --------------------------------------------------------- async save errors


def _failing_writer(path, **arrays):
    raise OSError("disk full (injected)")


def test_async_save_failure_surfaces_on_wait(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=True, writer=_failing_writer)
    m.save(1, make_state())
    with pytest.raises(CheckpointSaveError, match="disk full"):
        m.wait()
    m.wait()  # surfaced once: the manager is usable again


def test_async_save_failure_surfaces_on_latest_step(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=True, writer=_failing_writer)
    m.save(5, make_state())
    m._save_thread.join()  # let the worker die without consuming the error
    with pytest.raises(CheckpointSaveError):
        m.latest_step()


def test_async_save_failure_then_next_save_succeeds(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=True, writer=_failing_writer)
    state = make_state()
    m.save(1, state)
    m._save_thread.join()
    m._writer = np.savez  # the disk came back
    with pytest.raises(CheckpointSaveError):
        m.save(2, state)  # surfaces step 1's failure...
    m.save(2, state)  # ...and the retry goes through
    m.wait()
    assert m.latest_step() == 2
    assert_tree_equal(state, m.restore(state, 2))


def test_sync_save_failure_raises_inline(tmp_path):
    m = CheckpointManager(str(tmp_path), writer=_failing_writer)
    with pytest.raises(OSError, match="disk full"):
        m.save(1, make_state())


# --------------------------------------------------------- the shared format


def test_a_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path):
    RefManager(str(tmp_path)).save(4, jax_state(1))
    m = CheckpointManager(str(tmp_path))
    assert m.latest_step() == 4
    restored = m.restore(make_state(), 4)
    for x, y in zip(jax.tree.leaves(jax_state(1)), tree.leaves(restored)):
        assert tuple(x.shape) == tuple(y.shape)
        assert np.array_equal(bits(x), bits(y))
    assert restored["params"]["w"].dtype == torch.bfloat16 and restored["opt"]["step"].dtype == torch.int32


def test_a_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path):
    state = make_state(2)
    CheckpointManager(str(tmp_path)).save(6, state)
    with open(tmp_path / "step_0000000006" / "meta.json") as f:
        meta = json.load(f)
    assert meta["dtypes"] == {"opt/m": "float32", "opt/step": "int32", "params/b": "float32",
                              "params/w": "bfloat16"}
    assert np.load(tmp_path / "step_0000000006" / "arrays.npz")["params/w"].dtype == np.uint16
    restored = RefManager(str(tmp_path)).restore(jax_state(), 6)
    for x, y in zip(tree.leaves(state), jax.tree.leaves(restored)):
        assert tuple(x.shape) == tuple(y.shape)
        assert np.array_equal(bits(x), bits(y))
    assert restored["params"]["w"].dtype == jnp.bfloat16


def test_the_step_restores_as_a_0d_int32(tmp_path):
    m = CheckpointManager(str(tmp_path))
    state = make_state()
    m.save(1, state)
    step = m.restore(state, 1)["opt"]["step"]
    assert step.shape == () and step.dtype == torch.int32 and int(step) == 7
