"""Embedding lookup and tied LM head (bf16/fp32 tables).

Port of ``painlessinferenceacceleration_tpu/layers/embedding.py`` without the
fp8 table, which is not ported yet.
"""

from __future__ import annotations

import torch


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Gather token rows [..., E]."""
    if isinstance(emb, dict):
        raise NotImplementedError("fp8 embedding tables are not ported yet")
    return emb[tokens.long()].to(dtype)


def embed_logits(emb: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Tied LM head: ``h @ table^T`` with fp32 logits."""
    if isinstance(emb, dict):
        raise NotImplementedError("fp8 embedding tables are not ported yet")
    if h.is_cuda:
        raise NotImplementedError("a tied LM head on CUDA needs a GEMM kernel")
    return torch.matmul(h.to(torch.float32), emb.to(torch.float32).T)
