"""Provuse core: platform-side function fusion (the paper's contribution)."""
from repro_torch.core.billing import BillingMeter  # noqa: F401
from repro_torch.core.errors import (  # noqa: F401
    DeploymentError,
    InvocationError,
    ProvuseError,
    UnknownFunctionError,
)
from repro_torch.core.function import FunctionInstance, FunctionSpec, InstanceState  # noqa: F401
from repro_torch.core.handler import FunctionHandler  # noqa: F401
from repro_torch.core.lifecycle import ControlPlane, EpochEvent  # noqa: F401
from repro_torch.core.merger import MergeEvent, Merger  # noqa: F401
from repro_torch.core.platform import ProvusePlatform, TinyTorchBackend  # noqa: F401
from repro_torch.core.policy import FusionDecision, FusionPolicy  # noqa: F401
from repro_torch.scheduler.clock import SYSTEM_CLOCK, SystemClock  # noqa: F401
