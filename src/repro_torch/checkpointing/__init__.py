from repro_torch.checkpointing.manager import (  # noqa: F401
    SnapshotIntegrityError,
    SnapshotStore,
    snapshot_digest,
)
