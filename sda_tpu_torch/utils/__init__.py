"""Shared utilities: error types, the device rule, device timing, the
per-kernel breakdown and the card's roofline, the varint codec and logging."""

from sda_tpu_torch.utils.errors import Invalid, InvalidCredentials, PermissionDenied, SdaError

__all__ = ["SdaError", "PermissionDenied", "InvalidCredentials", "Invalid"]
