"""Shared utilities: error types, device timing and the H100 roofline, the
varint codec and logging."""

from sda_tpu_torch.utils.errors import Invalid, InvalidCredentials, PermissionDenied, SdaError

__all__ = ["SdaError", "PermissionDenied", "InvalidCredentials", "Invalid"]
