"""Token observation encoder (reference: mettagrid_tpu/policy/token_encoder.py).

Encodes the raw token stream (T, 3) uint8 = [packed_location, feature_id,
value] into a fixed-size embedding: the per-token sum of position-x,
position-y and feature embeddings scaled by the normalized value,
mean-pooled over the valid tokens, then Dense -> ReLU -> LayerNorm.

The pooled sum is linear in the embeddings, so it is computed without the
[..., T, hidden] per-token terms (37.7 GB at 98,304 agents x 500 tokens x
192): each agent's valid tokens add their scales into a histogram over
16 + 16 + num_features bins (column, row, feature id), and one matrix
product with the stacked embedding tables gives the pooled sum,
``Σ_t s_t (Ex[col_t] + Ey[row_t] + Ef[fid_t]) = Wx·Ex + Wy·Ey + Wf·Ef``.
On a CUDA tensor the histogram's ``scatter_add_`` sums each bin in no fixed
order, so two runs on the card may differ in the last bits of a float32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

EMPTY_TOKEN_BYTE = 0xFF
POS_BINS = 16


class TokenEncoder(nn.Module):
    # flax submodule names that differ from this module's (policy/interop.py).
    FLAX_NAMES = {"Dense_0": "dense", "LayerNorm_0": "norm"}

    def __init__(self, hidden_size: int = 192, num_features: int = 256, feature_norms: tuple[float, ...] = (),
                 device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_features = num_features
        self.pos_x_embed = nn.Embedding(POS_BINS, hidden_size, device=device)
        self.pos_y_embed = nn.Embedding(POS_BINS, hidden_size, device=device)
        self.feature_embed = nn.Embedding(num_features, hidden_size, device=device)
        self.dense = nn.Linear(hidden_size, hidden_size, device=device)
        # flax nn.LayerNorm's epsilon (torch's default is 1e-5).
        self.norm = nn.LayerNorm(hidden_size, eps=1e-6, device=device)
        # feature_norms[fid] divides that feature's value; missing ids take
        # 1.0, and with no norms every feature takes 255.
        if feature_norms:
            norms = np.ones(max(num_features, len(feature_norms)), np.float32)
            norms[: len(feature_norms)] = feature_norms
        else:
            norms = np.full(num_features, 255.0, np.float32)
        self.register_buffer("norms", torch.from_numpy(np.maximum(norms, 1.0)).to(device), persistent=False)

    def histogram(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens: uint8[B, T, 3] -> (summed scales float32[B, 32 +
        num_features] over the column, row and feature bins, valid-token
        counts float32[B])."""
        B = tokens.shape[0]
        loc = tokens[..., 0].long()
        fid = tokens[..., 1].long().clamp_(max=self.num_features - 1)
        valid = loc != EMPTY_TOKEN_BYTE
        scale = tokens[..., 2].float() / self.norms[fid]
        scale = scale * valid
        idx = torch.cat([loc & 0x0F, POS_BINS + ((loc >> 4) & 0x0F), 2 * POS_BINS + fid], dim=1)
        hist = torch.zeros((B, 2 * POS_BINS + self.num_features), dtype=torch.float32, device=tokens.device)
        hist.scatter_add_(1, idx, scale.repeat(1, 3))
        return hist, valid.sum(dim=-1).clamp_(min=1).float()

    def pool(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: uint8[B, T, 3] -> the masked mean of the valid tokens'
        scaled embeddings, float32[B, hidden_size]."""
        hist, denom = self.histogram(tokens)
        table = torch.cat([self.pos_x_embed.weight, self.pos_y_embed.weight, self.feature_embed.weight])
        return (hist @ table) / denom[:, None]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: uint8[..., T, 3] -> float32[..., hidden_size]."""
        batch = tokens.shape[:-2]
        pooled = self.pool(tokens.reshape(-1, *tokens.shape[-2:]))
        h = self.norm(torch.relu(self.dense(pooled)))
        return h.reshape(*batch, self.hidden_size)
