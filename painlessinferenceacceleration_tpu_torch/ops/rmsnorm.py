"""RMSNorm with fp32 statistics (plain torch).

Port of ``rms_norm`` in ``painlessinferenceacceleration_tpu/ops/rmsnorm.py``.
The JAX model path calls this jnp form, not the Pallas ``_rmsnorm_kernel``
(which only a benchmark calls); that kernel is not ported yet.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 variance and scaling, cast back to ``x.dtype``."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.to(torch.float32)).to(x.dtype)
