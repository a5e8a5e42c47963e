"""End-to-end aggregation workloads."""

from sda_tpu_torch.models.federated import FederatedAggregation

__all__ = ["FederatedAggregation"]
