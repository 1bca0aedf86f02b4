"""Embedding lookup and tied LM head, over bf16/fp32 tables and the fp8
table with dequant-on-gather.

Port of ``painlessinferenceacceleration_tpu/layers/embedding.py``. The fp8
table ``{"q": e4m3 [V, E], "s": f32 [V]}`` is quantized per vocab row; a
lookup reads one e4m3 row and one scale per token and dequantizes only the
gathered rows (a gather and a multiply: plain torch here, as it is plain
jnp there). In the tied LM head the row scales become per-vocab-column
factors applied after the matmul. On the card the tied head of a bf16 table
is the bf16 GEMM kernel over the transposed weight (``ops/moe_matmul.py``
``dense_matmul``); an fp8 table's tied head has no kernel and raises there.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from painlessinferenceacceleration_tpu_torch.layers.linear import FP8_MAX, QuantSpec

Embedding = Union[torch.Tensor, dict]


def make_embedding(w: Embedding, quant: Optional[QuantSpec] = None) -> Embedding:
    """Quantize a table [V, E] to e4m3 with per-row scales. Only fp8-class
    specs retype the table; anything else passes it through unchanged."""
    if quant is None or quant.wfmt != "fp8" or isinstance(w, dict):
        return w
    wf = w.to(torch.float32)
    s = torch.clamp(wf.abs().amax(dim=1) / FP8_MAX, min=1e-8)
    return {"q": (wf / s[:, None]).to(torch.float8_e4m3fn), "s": s}


def embed_lookup(emb: Embedding, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Gather token rows [..., E]; an fp8 table dequantizes only those."""
    idx = tokens.long()
    if isinstance(emb, dict):
        # e4m3 is gathered through its bytes (index kernels do not take it)
        rows = emb["q"].view(torch.uint8)[idx].view(torch.float8_e4m3fn)
        return (rows.to(torch.float32) * emb["s"][idx][..., None]).to(dtype)
    return emb[idx].to(dtype)


def embed_logits(emb: Embedding, h: torch.Tensor) -> torch.Tensor:
    """Tied LM head: ``h @ table^T`` with fp32 logits."""
    if isinstance(emb, dict):
        if h.is_cuda:
            raise NotImplementedError("a tied LM head over an fp8 table has no kernel")
        out = torch.matmul(h.to(torch.float32), emb["q"].to(torch.float32).T)
        return out * emb["s"]
    from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import dense_matmul

    return dense_matmul(h, emb.to(h.dtype) if h.is_cuda else emb, torch.float32,
                        transposed=True)
