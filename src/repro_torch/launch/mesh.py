"""Production and smoke meshes as ``DeviceMesh``es (the JAX package's
``repro/launch/mesh.py``).

Defined as FUNCTIONS (never module-level state), so importing this module
never touches a process group: the caller initialises
``torch.distributed`` first (one rank per card, or a fake group of 256 or
512 ranks for the dry run, :func:`init_fake_world`).

Single pod: (data=16, model=16) = 256 chips.
Multi-pod:  (pod=2, data=16, model=16) = 512 chips; the 'pod' axis is pure
data parallelism.
"""
from __future__ import annotations

import math
import os

PRODUCTION = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
# the dry run's mesh names (``launch/dryrun.py --mesh``) -> multi_pod
MESHES = {"pod16x16": False, "pod2x16x16": True}


def _device_type() -> str:
    """The device type of the initialised world's collectives: ``cuda``
    under NCCL, ``meta`` in a fake group (the dry run), else ``cpu``."""
    import torch.distributed as dist

    backend = dist.get_backend()
    if backend == "nccl":
        return "cuda"
    return "meta" if backend == "fake" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) over ('data', 'model'), or (2, 16, 16) over ('pod', 'data',
    'model'), over the first ranks of the initialised world."""
    import torch.distributed as dist

    shape, axes = PRODUCTION[multi_pod]
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for the production mesh, have {have} — "
            "run under dryrun.py --mesh (it makes a fake group of that size)"
        )
    return make_mesh(shape, axes)


def make_smoke_mesh():
    """Tiny mesh over every rank of the initialised world: (n // m, m) over
    ('data', 'model') with m = 2 when n is even and above 1, else 1."""
    import torch.distributed as dist

    n = dist.get_world_size()
    model = 2 if n % 2 == 0 and n > 1 else 1
    return make_mesh((n // model, model), ("data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A mesh of ``shape`` over ``axes`` on the first ranks of the
    initialised world, in row-major order."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axes))


def init_fake_world(world_size: int, rank: int = 0) -> None:
    """A fake process group of ``world_size`` ranks in this one process,
    seen from ``rank``: collectives on meta tensors give their shapes and
    move nothing (the dry run of a production mesh on one host)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        raise RuntimeError(f"a process group is initialised already ({dist.get_backend()}, "
                           f"{dist.get_world_size()} ranks)")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


def _rank_main(rank: int, target, world: int, backend: str, store_path: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(target, world: int, *args, backend: str = "gloo", store_dir: str | None = None) -> None:
    """Run ``target(rank, world, *args)`` in ``world`` new processes, each
    rank of one process group (``gloo`` on the host, ``nccl`` one card per
    rank) met through a ``FileStore`` in ``store_dir`` (a fresh temporary
    directory by default): no port is taken. Raises when any rank fails;
    every process has ended when it returns."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=store_dir) as d:
        mp.spawn(_rank_main, args=(target, world, backend, os.path.join(d, "store"), args), nprocs=world,
                 join=True)
