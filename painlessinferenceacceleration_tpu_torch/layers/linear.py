"""Weight-only int4 linear layers (and native bf16/fp32 ones, CPU only).

Port of ``painlessinferenceacceleration_tpu/layers/linear.py`` for the int4
path. Weights are stored pre-transposed as ``[in, out]``. A linear leaf is
either a plain tensor (native) or a dict of tensors::

    int4: {"q": uint8[in/2, out] packed nibbles, "s": bf16[in/group, out]}

Two parts are data contracts with the JAX package and are ported exactly,
so that JAX-packed weights load byte for byte:

- the bf16 scales are rounded UP from the fp32 amax/7 scale;
- the nibbles are biased (+8) and plane-baked: byte ``j`` of a group holds
  row ``losrc[j]`` in its low nibble and row ``losrc[j] + g/2`` in its high
  nibble, with ``losrc = j//2 + (j%2)*(g/4)``.

Stacked per-layer leaves ``[L, ...]`` are indexed per layer (a view, no copy).
int8, W8A8 and fp8 weights are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

LinearParams = Union[torch.Tensor, dict]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static quantization descriptor (weight-only int4 in this port)."""

    bits: int = 4
    group: int = 128

    @classmethod
    def from_mode(cls, mode: Optional[str], group: int = 128) -> Optional["QuantSpec"]:
        """``EngineConfig.quant`` -> spec (None for native weights)."""
        if mode in ("none", "", None):
            return None
        if mode == "int4":
            return cls(bits=4, group=group)
        if mode == "int8":
            raise NotImplementedError(
                "int8 weight-only linears come with the int8 slice (ROADMAP B.1)")
        if mode.startswith("w8a8") or mode == "fp8":
            raise NotImplementedError(
                f"quant={mode!r}: W8A8 / fp8 linears come with the W8A8 slice "
                "(ROADMAP B.2)")
        raise ValueError(f"unknown quant mode {mode!r}")


def effective_group(din: int, group: int) -> int:
    g = min(group, din)
    return g if din % g == 0 else din


def _losrc(g: int) -> torch.Tensor:
    j = torch.arange(g // 2)
    return j // 2 + (j % 2) * (g // 4)


def _group_scales(w: torch.Tensor, group: int, qmax: float):
    """Per-(group, out-channel) symmetric bf16 scales for w [in, out],
    rounded up so the group's largest weight never clips."""
    din, dout = w.shape
    g = effective_group(din, group)
    wg = w.reshape(din // g, g, dout).to(torch.float32)
    amax = wg.abs().amax(dim=1)
    scale = torch.clamp(amax / qmax, min=1e-8)
    scale_bf = scale.to(torch.bfloat16)
    next_up = (scale_bf.view(torch.int16) + 1).view(torch.bfloat16)
    scale_bf = torch.where(scale_bf.to(torch.float32) < scale, next_up, scale_bf)
    return wg, scale_bf, g


def quantize(w: torch.Tensor, spec: QuantSpec) -> dict:
    """Symmetric int4 quantization of w [in, out] into the packed layout."""
    if spec.bits != 4:
        raise NotImplementedError(f"{spec.bits}-bit weights are not ported yet")
    wg, scale, g = _group_scales(w, spec.group, 7.0)
    if g % 8:
        raise ValueError("int4 packing needs group % 8 == 0")
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -8, 7).to(torch.int32) + 8
    losrc = _losrc(g).to(w.device)
    lo = q[:, losrc] & 0xF
    hi = (q[:, losrc + g // 2] & 0xF) << 4
    din, dout = w.shape
    return {"q": (lo | hi).to(torch.uint8).reshape(din // 2, dout), "s": scale}


def unpack_int4(packed: torch.Tensor, group: int) -> torch.Tensor:
    """[K/2, N] uint8 (biased plane-baked layout) -> [K, N] int8 (signed)."""
    k2, n = packed.shape
    g = min(group, k2 * 2)
    p = packed.reshape(k2 * 2 // g, g // 2, n).to(torch.int32)
    both = torch.cat([(p & 0xF) - 8, ((p >> 4) & 0xF) - 8], dim=1)
    losrc = _losrc(g)
    inv = torch.empty(g, dtype=torch.long)
    inv[losrc] = torch.arange(g // 2)
    inv[losrc + g // 2] = torch.arange(g // 2) + g // 2
    return both[:, inv.to(packed.device)].reshape(k2 * 2, n).to(torch.int8)


def dequantize(p: dict, spec: Optional[QuantSpec] = None,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Dense weight [in, out] from an int4 leaf (plain reference path)."""
    q, s = p["q"], p["s"]
    din = q.shape[0] * 2
    g = din // s.shape[0]
    w = unpack_int4(q, g).to(torch.float32)
    w = w.reshape(din // g, g, -1) * s.to(torch.float32)[:, None, :]
    return w.reshape(din, -1).to(dtype)


def _native(x: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    if x.is_cuda:
        raise NotImplementedError(
            "native linears on CUDA need a GEMM kernel; this path is int4"
        )
    out = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return out.to(out_dtype or x.dtype)


def linear(
    p: LinearParams,
    x: torch.Tensor,
    spec: Optional[QuantSpec] = None,
    out_dtype=None,
) -> torch.Tensor:
    """``x @ W``; int4 leaves go to the int4 GEMM wrapper.

    ``out_dtype`` keeps the fp32 accumulator un-rounded at the output (the
    LM head passes fp32, as in the JAX package)."""
    if isinstance(p, dict):
        from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
            int4_matmul,
        )

        return int4_matmul(x, p["q"], p["s"], out_dtype=out_dtype or x.dtype)
    return _native(x, p, out_dtype)


def linear_at(
    p_stacked: LinearParams,
    li: int,
    x: torch.Tensor,
    spec: Optional[QuantSpec] = None,
) -> torch.Tensor:
    """``x @ W[li]`` over stacked leaves [L, ...] (a per-layer view)."""
    if isinstance(p_stacked, dict):
        p = {"q": p_stacked["q"][li], "s": p_stacked["s"][li]}
    else:
        p = p_stacked[li]
    return linear(p, x, spec)
