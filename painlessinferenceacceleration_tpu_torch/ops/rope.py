"""Rotary position embeddings: the default, linear, llama3 and YaRN
frequency rules, the rotate-half and the interleaved pairing.

Port of ``painlessinferenceacceleration_tpu/ops/rope.py``. All math is fp32.
The YaRN attention factor rides on cos/sin for the dense attention path
(``dense_cos_sin``); the MLA path takes it as mscale² in its softmax scale
instead (``models/mla.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from painlessinferenceacceleration_tpu_torch.ops.rmsnorm import rms_norm


def rope_inv_freq(cfg, device=None) -> torch.Tensor:
    """Per-pair inverse frequencies [dim/2] (fp32), with the HF rope_scaling
    rule applied; dim is ``qk_rope_head_dim`` when set (MLA), else the head
    dim, times ``partial_rotary_factor`` where that is below 1 (chatglm and
    gptj rotate the first lanes only)."""
    dim = cfg.qk_rope_head_dim or cfg.head_dim
    if cfg.partial_rotary_factor < 1.0:
        dim = int(dim * cfg.partial_rotary_factor)
    base = cfg.rope_theta
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    inv = 1.0 / (base ** exponent)
    sc = cfg.rope_scaling_dict()
    if not sc:
        return inv
    rt = sc.get("rope_type", sc.get("type", "default"))
    if rt in ("default", "none"):
        return inv
    if rt == "linear":
        return inv / float(sc["factor"])
    if rt == "llama3":  # llama-3.1 frequency bands
        factor = float(sc["factor"])
        lo = float(sc.get("low_freq_factor", 1.0))
        hi = float(sc.get("high_freq_factor", 4.0))
        old_ctx = float(sc.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * math.pi / inv
        low_wl, high_wl = old_ctx / lo, old_ctx / hi
        smooth = (old_ctx / wavelen - lo) / (hi - lo)
        scaled = torch.where(wavelen > low_wl, inv / factor, inv)
        mid = (1.0 - smooth) * inv / factor + smooth * inv
        is_mid = (wavelen <= low_wl) & (wavelen >= high_wl)
        return torch.where(is_mid, mid, scaled)
    if rt == "yarn":  # NTK-by-parts interpolation
        factor = float(sc["factor"])
        orig = float(sc.get("original_max_position_embeddings", 4096))
        beta_fast = float(sc.get("beta_fast", 32))
        beta_slow = float(sc.get("beta_slow", 1))

        def find_dim(num_rot):
            return (dim * math.log(orig / (num_rot * 2 * math.pi))) / (2 * math.log(base))

        low = max(math.floor(find_dim(beta_fast)), 0)
        high = min(math.ceil(find_dim(beta_slow)), dim - 1)
        r = torch.arange(dim // 2, dtype=torch.float32, device=device)
        ramp = torch.clamp((r - low) / max(high - low, 0.001), 0.0, 1.0)
        return inv / factor * ramp + inv * (1.0 - ramp)
    raise ValueError(f"unsupported rope_type {rt!r}")


def yarn_mscale(cfg) -> float:
    """The YaRN attention magnitude factor (1.0 for every other rope type).

    It reads ``mscale``, as the JAX package does (HF DeepSeek's softmax
    scale reads ``mscale_all_dim``; the two are equal for DeepSeek-V2-Lite)."""
    sc = cfg.rope_scaling_dict()
    if not sc or sc.get("rope_type", sc.get("type", "default")) != "yarn":
        return 1.0
    factor = float(sc["factor"])
    if factor <= 1.0:
        return 1.0
    return 0.1 * float(sc.get("mscale", 1.0)) * math.log(factor) + 1.0


def rope_cos_sin(inv_freq: torch.Tensor, positions: torch.Tensor, mscale: float = 1.0):
    """cos/sin [..., dim/2] for integer positions [...] (fp32), times
    ``mscale`` (the YaRN factor folded in, so q·k picks up mscale²)."""
    angles = positions.to(torch.float32)[..., None] * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    return cos, sin


def dense_cos_sin(cfg, positions: torch.Tensor):
    """cos/sin of the dense (non-MLA) attention path, the YaRN factor
    applied."""
    return rope_cos_sin(rope_inv_freq(cfg, positions.device), positions, yarn_mscale(cfg))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleaved: bool = False) -> torch.Tensor:
    """Rotate ``x`` [..., H, D] with cos/sin [..., D/2] (broadcast over H):
    pairs (i, i + D/2) (HF "rotate_half"), or with ``interleaved`` pairs
    (2i, 2i + 1) (GPT-J, DeepSeek's MLA)."""
    xf = x.to(torch.float32)
    c = cos[..., None, :]
    s = sin[..., None, :]
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x.shape)
    else:
        half = x.shape[-1] // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_qk_rope(q: torch.Tensor, k: torch.Tensor, inv_freq: torch.Tensor,
                  positions: torch.Tensor, q_norm: Optional[torch.Tensor] = None,
                  k_norm: Optional[torch.Tensor] = None, eps: float = 1e-6):
    """Optional QK-RMSNorm, then rope, for q [B, T, Hq, D] and k
    [B, T, Hk, D] at ``positions`` [B, T] (Qwen3's fused qk-norm + rope;
    the norms go through ``ops/rmsnorm.py``'s kernel on the card)."""
    if q_norm is not None:
        q = rms_norm(q, q_norm, eps)
    if k_norm is not None:
        k = rms_norm(k, k_norm, eps)
    cos, sin = rope_cos_sin(inv_freq, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
