from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_state_defs,
    adamw_update,
    adamw_update_,
    global_norm,
)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
