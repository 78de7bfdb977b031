"""Model modules of the port, one per module of drn_tpu/models."""

from drn_tpu_torch.models.drn import DRN, location_metadata  # noqa: F401
