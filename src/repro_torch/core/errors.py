"""Platform error types."""


class ProvuseError(Exception):
    """Base class for platform errors."""


class UnknownFunctionError(ProvuseError):
    pass


class DeploymentError(ProvuseError):
    pass


class InvocationError(ProvuseError):
    pass
