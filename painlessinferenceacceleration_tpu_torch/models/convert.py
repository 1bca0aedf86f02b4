"""Parameters from the JAX package into the port.

``params_from_jax`` takes the JAX parameter pytree with its leaves already
turned into numpy arrays (``jax.tree.map(np.asarray, params)``), so this
module needs no JAX. The tree shape is the same in both packages; int4
``{"q", "s"}`` leaves keep their packed bytes unchanged. bf16 crosses over
through a ``uint16`` view, since ``torch.from_numpy`` does not take the
ml_dtypes bf16 type.
"""

from __future__ import annotations

import numpy as np
import torch

from painlessinferenceacceleration_tpu_torch._build import resolve_device


def _tensor(a: np.ndarray, device=None) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])  # torch wants writable
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def params_from_jax(tree, device=None):
    """Nested dicts of numpy arrays -> the same nesting of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree), device)
