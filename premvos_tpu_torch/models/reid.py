"""Triplet-ReID embedding network (port of premvos_tpu/models/reid.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from premvos_tpu_torch.config import ReIDConfig
from premvos_tpu_torch.models.layers import Dense
from premvos_tpu_torch.models.resnet import ResNet


class ReIDNet(nn.Module):
    def __init__(self, cfg: ReIDConfig = ReIDConfig(), dtype=torch.float32):
        super().__init__()
        self.l2_normalize = cfg.l2_normalize
        self.backbone = ResNet(depth=cfg.backbone_depth, norm=cfg.norm, dtype=dtype)
        self.fc1 = Dense(2048, 1024, dtype)
        self.emb = Dense(1024, cfg.embedding_dim, dtype)

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        """[N, 3, S, S] crops → [N, E] float32 embeddings."""
        x = self.backbone(crops)["C5"].mean(dim=(-2, -1))  # global average pool
        x = F.relu(self.fc1(x))
        emb = self.emb(x).to(torch.float32)
        if self.l2_normalize:
            emb = emb / torch.clamp(
                torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-6
            )
        return emb
