"""Embedding lookup and tied LM head, over bf16/fp32 tables and the fp8
table with dequant-on-gather.

Port of ``painlessinferenceacceleration_tpu/layers/embedding.py``. The fp8
table ``{"q": e4m3 [V, E], "s": f32 [V]}`` is quantized per vocab row; a
lookup reads one e4m3 row and one scale per token and dequantizes only the
gathered rows (a gather and a multiply: plain torch here, as it is plain
jnp there). In the tied LM head the row scales become per-vocab-column
factors applied after the matmul. On the card the tied head of a bf16 table
is the bf16 GEMM kernel over the transposed weight (``ops/moe_matmul.py``
``dense_matmul``), and an fp8 table's is the e4m3 head GEMM
(``ops/quant_matmul.py`` ``fp8_head_matmul``: the table widened to bf16 in
shared memory, each vocab column's fp32 sum times its scale once).

``pad_vocab_rows`` pads a tied table to a multiple of 8 rows with zeros
(GPT-2's 50257 -> 50264: the bf16 GEMM takes N % 8 == 0), so the head
gives as many logits more; ``models/base.py`` ``logits_from_hidden`` cuts
them back to ``vocab_size`` before anything reads them. A lookup never
reads a padding row.
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


VOCAB_ROWS = 8  # a tied table's rows are padded to a multiple of this


def pad_vocab_rows(params: dict) -> dict:
    """``params`` with a tied table (no ``lm_head``) padded with zero rows
    (and, for an e4m3 table, scales of 1) to a multiple of ``VOCAB_ROWS``;
    the same dict where there is nothing to pad."""
    emb = params.get("embed")
    if emb is None or "lm_head" in params:
        return params
    V = (emb["q"] if isinstance(emb, dict) else emb).shape[0]
    pad = -V % VOCAB_ROWS
    if pad == 0:
        return params

    def rows(t, fill):
        extra = torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=t.device)
        return torch.cat([t, extra])

    params = dict(params)
    if isinstance(emb, dict):  # e4m3 through its bytes (cat does not take it everywhere)
        q = rows(emb["q"].view(torch.uint8), 0).view(torch.float8_e4m3fn)
        params["embed"] = {"q": q, "s": rows(emb["s"], 1.0)}
    else:
        params["embed"] = rows(emb, 0)
    return params


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
        from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import fp8_head_matmul

        return fp8_head_matmul(h, emb["q"], emb["s"])
    from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import dense_matmul

    return dense_matmul(h, emb.to(h.dtype) if h.is_cuda else emb, torch.float32,
                        transposed=True)
