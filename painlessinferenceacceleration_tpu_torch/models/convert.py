"""Parameters and KV arenas from the JAX package into the port.

``params_from_jax`` and ``kv_from_jax`` take JAX pytrees with their leaves
already turned into numpy arrays (``jax.tree.map(np.asarray, tree)``), so
this module needs no JAX. The tree shape is the same in both packages;
quantized ``{"q", "s"[, "xs"]}`` leaves keep their bytes unchanged (packed
int4, int8, e4m3, bf16 and f32 scales, the 0-d or ``[L]`` static activation
scale). bf16 crosses over through a ``uint16`` view and e4m3 through a
``uint8`` view, since ``torch.from_numpy`` does not take the ml_dtypes
types, so weights and arenas compare byte for byte. ``distill_state_from_jax``
carries a JAX IPAD ``Distiller``'s training state over the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from painlessinferenceacceleration_tpu_torch._build import resolve_device


def _tensor(a: np.ndarray, device=None) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])  # torch wants writable
    # bf16: ml_dtypes' type, or the 2-byte void numpy reads it back as from
    # an npz file
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def params_from_jax(tree, device=None):
    """Nested dicts (and lists or tuples, as a hybrid's per-layer
    ``hybrid_layers``) of numpy arrays -> the same nesting of torch tensors,
    sequences as lists."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _tensor(np.asarray(tree), device)


def kv_from_jax(tree: dict, n_kv_heads: int, device=None, k_row: int = 0) -> dict:
    """A JAX KV arena dict (``init_kv_cache``'s keys) as the port's arena.

    The JAX per-token scale arenas ``[L, n_pages, ps, 128]`` are padded to
    128 lanes for the TPU's DMA tiles; the port keeps the real
    ``n_kv_heads`` lanes. So is the K row of an MLA latent arena (576 lanes
    padded to 640 at DeepSeek's widths): with ``k_row`` (the port's K row
    width, ``models/mla.py`` ``mla_head_dims``) its pad lanes are dropped;
    the V arena crosses as it is."""
    out = {}
    for name, a in tree.items():
        a = np.asarray(a)
        if name in ("k_tok_scale", "v_tok_scale"):
            a = a[..., :n_kv_heads]
        elif name == "k" and k_row:
            a = a[..., :k_row]
        out[name] = _tensor(a, device)
    return out


def distill_state_from_jax(distiller, state: dict) -> None:
    """Set a port ``ipad.Distiller`` to a JAX ``Distiller``'s training state,
    given as numpy: ``student``, ``masks`` and ``saliency`` (trees of arrays),
    optax's ``mu``, ``nu`` and ``count`` (the ``ScaleByAdamState`` at
    ``opt_state[0]``) and ``step_idx``. Both packages then train on from one
    state."""
    dev = distiller.device
    distiller.set_state(
        student=params_from_jax(state["student"], dev), mu=params_from_jax(state["mu"], dev),
        nu=params_from_jax(state["nu"], dev), count=int(state["count"]),
        masks=params_from_jax(state["masks"], dev),
        saliency=params_from_jax(state["saliency"], dev), step_idx=int(state["step_idx"]))
