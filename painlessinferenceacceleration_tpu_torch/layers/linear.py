"""Quantized linear layers, and native ones (bf16 on the card).

Port of ``painlessinferenceacceleration_tpu/layers/linear.py``. Weights are
stored pre-transposed as ``[in, out]``. A linear leaf is either a plain
tensor (native) or a dict of tensors; the static description lives in
``QuantSpec``::

    int4:      {"q": uint8[in/2, out] packed nibbles, "s": bf16[in/group, out]}
    int8:      {"q": int8[in, out],                   "s": bf16[in/group, out]}
    W8A8:      {"q": int8 | e4m3 [in, out], "s": f32[out]} (+ "xs": f32 scalar,
               the calibrated activation scale of the static variants)
    block fp8: {"q": e4m3[in, out], "s": f32[ceil(in/128), ceil(out/128)]}

These are data contracts with the JAX package and are ported exactly, so
that JAX-quantized weights load byte for byte:

- the bf16 group scales are rounded UP from the fp32 amax/qmax scale;
- the int4 nibbles are biased (+8) and plane-baked: byte ``j`` of a group
  holds row ``losrc[j]`` in its low nibble and row ``losrc[j] + g/2`` in its
  high nibble, with ``losrc = j//2 + (j%2)*(g/4)``;
- W8A8 weights carry one fp32 scale per output channel, block-fp8 weights
  one per 128x128 block (edge blocks are partial, zero-padded for the amax).

Stacked per-layer leaves ``[L, ...]`` are indexed per layer (a view, no
copy) for every key of the leaf. The GEMMs live in ``ops/quant_matmul.py``
and ``ops/w8a8.py``; a native weight on the card goes to the bf16 GEMM kernel
in ``ops/moe_matmul.py`` (``dense_matmul``), whose sums do not depend on the
row count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

LinearParams = Union[torch.Tensor, dict]


FP8_MAX = 448.0  # float8_e4m3fn


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static quantization descriptor shared by all quantized linears.

    Weight-only (``act is None``): int8 / int4 with per-(group, out-channel)
    bf16 scales. Activation-quantized (W8A8): ``act`` says where the
    activation scale comes from ("dyn": per-token amax; "static": the
    calibrated scalar stored in the leaf), ``wfmt`` the 8-bit format ("int"
    or "fp8" = float8_e4m3fn); weights carry per-out-channel scales.
    ``block=128`` is the 128x128-block fp8 format with per-(token, K-block)
    activation scales; ``act_pow2`` snaps those to powers of two (the
    token-block variant)."""

    bits: int = 8  # 8 | 4
    group: int = 128  # input-dim group size of weight-only scales
    wfmt: str = "int"  # "int" | "fp8"
    act: Optional[str] = None  # None | "dyn" | "static"
    block: int = 0  # 0 | 128
    act_pow2: bool = False

    @classmethod
    def from_mode(cls, mode: Optional[str], group: int = 128) -> Optional["QuantSpec"]:
        """``EngineConfig.quant`` -> spec (None for native weights)."""
        if mode in ("none", "", None):
            return None
        if mode == "int8":
            return cls(bits=8, group=group)
        if mode == "int4":
            return cls(bits=4, group=group)
        if mode == "w8a8_int8":
            return cls(bits=8, act="dyn")
        if mode == "w8a8_int8_static":
            return cls(bits=8, act="static")
        if mode == "w8a8_fp8":
            return cls(bits=8, wfmt="fp8", act="dyn")
        if mode == "w8a8_fp8_static":
            return cls(bits=8, wfmt="fp8", act="static")
        if mode == "fp8_block":
            return cls(bits=8, wfmt="fp8", act="dyn", block=128)
        if mode == "fp8_tb":
            return cls(bits=8, wfmt="fp8", act="dyn", block=128, act_pow2=True)
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


def _pad_blocks(w: torch.Tensor, B: int):
    """w [K, N] in fp32, zero-padded to whole BxB blocks: [kb, B, nb, B]."""
    din, dout = w.shape
    kb, nb = -(-din // B), -(-dout // B)
    wp = torch.zeros((kb * B, nb * B), dtype=torch.float32, device=w.device)
    wp[:din, :dout] = w.to(torch.float32)
    return wp.reshape(kb, B, nb, B)


def quantize(w: torch.Tensor, spec: QuantSpec,
             act_scale: Optional[float] = None) -> dict:
    """Symmetric quantization of w [in, out] per ``spec``.

    ``act_scale`` seeds the stored activation scale of a static-act spec
    (default 1.0; see ``ops.w8a8.calibrate_act_scale``). The e4m3 casts
    need no clip: the scale puts every value within +-448."""
    din, dout = w.shape
    if spec.block:
        B = spec.block
        wb = _pad_blocks(w, B)
        scale = torch.clamp(wb.abs().amax(dim=(1, 3)) / FP8_MAX, min=1e-8)
        q = (wb / scale[:, None, :, None]).to(torch.float8_e4m3fn)
        q = q.reshape(wb.shape[0] * B, wb.shape[2] * B)[:din, :dout]
        return {"q": q.contiguous(), "s": scale}
    if spec.act is not None:
        wf = w.to(torch.float32)
        amax = wf.abs().amax(dim=0)
        if spec.wfmt == "fp8":
            scale = torch.clamp(amax / FP8_MAX, min=1e-8)
            q = (wf / scale[None, :]).to(torch.float8_e4m3fn)
        else:
            scale = torch.clamp(amax / 127.0, min=1e-8)
            q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(torch.int8)
        p = {"q": q, "s": scale}
        if spec.act == "static":
            p["xs"] = torch.tensor(1.0 if act_scale is None else float(act_scale),
                                   dtype=torch.float32, device=w.device)
        return p
    if spec.bits == 8:
        wg, scale, g = _group_scales(w, spec.group, 127.0)
        q = torch.clamp(torch.round(wg / scale[:, None, :]), -127, 127).to(torch.int8)
        return {"q": q.reshape(din, dout), "s": scale}
    if spec.bits == 4:
        wg, scale, g = _group_scales(w, spec.group, 7.0)
        if g % 8:
            raise ValueError("int4 packing needs group % 8 == 0")
        q = torch.clamp(torch.round(wg / scale[:, None, :]), -8, 7).to(torch.int32) + 8
        losrc = _losrc(g).to(w.device)
        lo = q[:, losrc] & 0xF
        hi = (q[:, losrc + g // 2] & 0xF) << 4
        return {"q": (lo | hi).to(torch.uint8).reshape(din // 2, dout), "s": scale}
    raise ValueError(spec)


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
    """Dense weight [in, out] from a quantized leaf (plain reference path).
    Without a spec the leaf is weight-only: int8, or int4 for packed uint8."""
    q, s = p["q"], p["s"]
    if spec is None:
        spec = QuantSpec(bits=4 if q.dtype == torch.uint8 else 8)
    if spec.block:
        B = spec.block
        din, dout = q.shape
        w = _pad_blocks(q, B) * s[:, None, :, None]
        return w.reshape(s.shape[0] * B, s.shape[1] * B)[:din, :dout].to(dtype)
    if spec.act is not None:
        return (q.to(torch.float32) * s[None, :]).to(dtype)
    if spec.bits == 8:
        w = q.to(torch.float32)
    else:
        din = q.shape[0] * 2
        w = unpack_int4(q, din // s.shape[0]).to(torch.float32)
    din, dout = w.shape
    g = din // s.shape[0]
    w = w.reshape(din // g, g, dout) * s.to(torch.float32)[:, None, :]
    return w.reshape(din, dout).to(dtype)


def make_linear(w: torch.Tensor, spec: Optional[QuantSpec]) -> LinearParams:
    return w if spec is None else quantize(w, spec)


def _native(x: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import dense_matmul

    return dense_matmul(x, w.to(x.dtype) if x.is_cuda else w, out_dtype)


def linear(
    p: LinearParams,
    x: torch.Tensor,
    spec: Optional[QuantSpec] = None,
    out_dtype=None,
) -> torch.Tensor:
    """``x @ W``; quantized leaves go to ``ops.quant_matmul.quant_matmul``.

    ``out_dtype`` keeps the fp32 accumulator un-rounded at the output (the
    LM head passes fp32, as in the JAX package)."""
    if isinstance(p, dict):
        from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
            quant_matmul,
        )

        return quant_matmul(x, p, spec, out_dtype=out_dtype)
    return _native(x, p, out_dtype)


def linear_at(
    p_stacked: LinearParams,
    li: int,
    x: torch.Tensor,
    spec: Optional[QuantSpec] = None,
    out_dtype=None,
) -> torch.Tensor:
    """``x @ W[li]`` over stacked leaves [L, ...] (a per-layer view)."""
    if isinstance(p_stacked, dict):
        p = {k: v[li] for k, v in p_stacked.items()}
    else:
        p = p_stacked[li]
    return linear(p, x, spec, out_dtype)
