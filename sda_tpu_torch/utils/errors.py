"""Error model for the framework.

A copy of the reference package's error hierarchy, kept so that the port
imports nothing of it. It mirrors the upstream protocol's error kinds
(PermissionDenied / InvalidCredentials / Invalid) as a small exception
hierarchy instead of Rust's error_chain.
"""


class SdaError(Exception):
    """Base error for all framework failures."""


class PermissionDenied(SdaError):
    """Caller is not allowed to perform the operation (ACL failure)."""

    def __init__(self, message: str = "permission denied"):
        super().__init__(message)


class InvalidCredentials(SdaError):
    """Authentication failed (bad or missing auth token)."""

    def __init__(self, message: str = "invalid credentials"):
        super().__init__(message)


class Invalid(SdaError):
    """Request or state is invalid (generic 400-class error)."""
