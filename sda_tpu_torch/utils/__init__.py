"""Shared utilities: error types and device timing."""

from sda_tpu_torch.utils.errors import Invalid, InvalidCredentials, PermissionDenied, SdaError

__all__ = ["SdaError", "PermissionDenied", "InvalidCredentials", "Invalid"]
