from repro_torch.training.loop import FailureInjector, InjectedFailure, StragglerEvent, TrainLoop  # noqa: F401
from repro_torch.training.train_step import (  # noqa: F401
    init_train_state,
    make_train_state_defs,
    make_train_step,
)
