"""Rotary position embeddings (default rope type, HF "rotate_half" layout).

Port of ``painlessinferenceacceleration_tpu/ops/rope.py`` for the default
rope type; the scaled types (linear, llama3, yarn) raise until they are
ported. All math is fp32.
"""

from __future__ import annotations

import torch


def rope_inv_freq(cfg, device=None) -> torch.Tensor:
    """Per-pair inverse frequencies [head_dim/2] (fp32)."""
    sc = cfg.rope_scaling_dict()
    if sc and sc.get("rope_type", sc.get("type", "default")) not in ("default", "none"):
        raise NotImplementedError(f"rope scaling {sc!r} is not ported yet")
    dim = cfg.head_dim
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (cfg.rope_theta ** exponent)


def rope_cos_sin(inv_freq: torch.Tensor, positions: torch.Tensor):
    """cos/sin [..., dim/2] for integer positions [...] (fp32)."""
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., H, D] with cos/sin [..., D/2] (broadcast over H)."""
    xf = x.to(torch.float32)
    c = cos[..., None, :]
    s = sin[..., None, :]
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
