"""Model substrate: layers, GQA attention, the dense decoder stack."""

from repro_torch.models.api import Model, build_model
from repro_torch.models.config import LayerKind, ModelConfig
