"""RMSNorm with fp32 statistics (plain torch).

Port of ``rms_norm`` in ``painlessinferenceacceleration_tpu/ops/rmsnorm.py``.
The JAX model path calls this jnp form, not the Pallas ``_rmsnorm_kernel``
(which only a benchmark calls); that kernel is not ported yet.

The mean square is summed in fp64 and then rounded to fp32. torch's CUDA
reduction picks its summation tree by the number of rows, so an fp32 sum
would give a row other bits at another batch width, and a served request's
tokens would depend on its neighbours (lookahead's lossless check compares
streams served at different widths). The fp64 sum of fp32 squares rounds
to the same fp32 value in any order, except in the rare case where the
exact sum lies within ~2^-41 of an fp32 rounding boundary.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 scaling (fp64-summed variance), cast back to ``x.dtype``."""
    xf = x.to(torch.float32)
    var = ((xf * xf).sum(dim=-1, keepdim=True, dtype=torch.float64)
           / x.shape[-1]).to(torch.float32)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.to(torch.float32)).to(x.dtype)
