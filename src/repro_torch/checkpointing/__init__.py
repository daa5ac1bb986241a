from repro_torch.checkpointing.manager import (  # noqa: F401
    CheckpointManager,
    CheckpointSaveError,
    SnapshotIntegrityError,
    SnapshotStore,
    snapshot_digest,
)
