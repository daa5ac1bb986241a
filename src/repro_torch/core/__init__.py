"""Provuse core: platform-side function fusion (the paper's contribution)."""
from repro_torch.core.autoscaler import Autoscaler  # noqa: F401
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
from repro_torch.core.merger import GroupRecord, MergeEvent, Merger, SplitEvent  # noqa: F401
from repro_torch.core.platform import OrchestratedBackend, ProvusePlatform, TinyTorchBackend  # noqa: F401
from repro_torch.core.policy import FusionDecision, FusionPolicy, SplitDecision  # noqa: F401
from repro_torch.core.registry import (  # noqa: F401
    LeastOutstandingSpread,
    RoundRobinSpread,
    RoutingTable,
    SpreadPolicy,
)
from repro_torch.scheduler.clock import SYSTEM_CLOCK, SystemClock, VirtualClock  # noqa: F401
from repro_torch.scheduler.slo import BEST_EFFORT, IMMEDIATE, SLOClass  # noqa: F401
