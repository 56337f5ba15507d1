"""Modality frontend stubs: precomputed patch or frame embeddings.

The counterpart of ``src/repro/models/frontends.py``'s ``fake_frontend``.
The vision-language and speech configs specify the transformer backbone
only; their frontends are stubs that hand the backbone synthetic
embeddings: ``frontend_len`` patch embeddings before the text of a
``vlm`` model, or the source frames an enc-dec model's encoder reads.
(The reference's ``frontend_spec`` is a shape stand-in for its dry-run.)
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig


def fake_frontend(cfg: ModelConfig, batch: int, gen: torch.Generator,
                  length: Optional[int] = None,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Synthetic embeddings ``(batch, length, d_model)``, N(0, 0.02^2) from
    ``gen`` on its device; ``length`` defaults to ``cfg.frontend_len``."""
    length = cfg.frontend_len if length is None else length
    x = torch.randn((batch, length, cfg.d_model), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return (x * 0.02).to(dtype)
