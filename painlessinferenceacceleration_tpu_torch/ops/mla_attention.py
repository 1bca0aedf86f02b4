"""MLA attention over the fused ``[latent | roped k_pe]`` page arena: the
kernel wrapper and its plain version.

``mla_paged_attention`` replaces the Pallas ``_mla_kernel``
(``painlessinferenceacceleration_tpu/ops/mla_attention.py``): weight-absorbed
MQA in latent space, where every q head attends the one shared K "head" of
the latent arena and a key's value is the first ``v_dim`` lanes of its K row,
so only the K arena is read. On a CUDA tensor it launches
``csrc/mla_attention.cu`` (K13) or raises; on a CPU tensor it takes
``mla_paged_attention_plain``, which is ``paged_attention_ref`` with V = K's
first ``v_dim`` lanes. The scale multiplies the fp32 scores in both (the
Pallas wrapper rounds ``q * scale`` to q's dtype first).

``launches`` counts the kernel's launches and ``modes`` counts them by width
kind (decode Q = 1, verify with a mask, prefill with the causal rule).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from painlessinferenceacceleration_tpu_torch import _build
from painlessinferenceacceleration_tpu_torch.ops.attention import (
    causal_qmask,
    paged_attention_ref,
)

MAX_V_DIM = 512  # csrc/mla_attention.cu: two V lanes for each of 256 threads


def mla_paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                              page_tables: torch.Tensor, ctx_lens: torch.Tensor,
                              qmask: torch.Tensor, scale: float,
                              v_dim: int) -> torch.Tensor:
    """Gather-then-attend over one layer's latent pages [n_pages, ps, Dk],
    V = each K row's first ``v_dim`` lanes. Returns [B, Q, H, v_dim]."""
    return paged_attention_ref(q, k_pages, k_pages[..., :v_dim], page_tables, ctx_lens,
                               qmask, scale, v_dim=v_dim)


def _launch(q, k_pages, page_tables, ctx_lens, qmask, scale, v_dim, causal):
    B, Q, H, Dk = q.shape
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16:
        raise TypeError(f"mla_paged_attention takes bf16 q and pages, not "
                        f"{q.dtype}/{k_pages.dtype}")
    if k_pages.dim() != 3 or k_pages.shape[2] != Dk:
        raise ValueError(f"pages {tuple(k_pages.shape)} are not one layer's "
                         f"[n_pages, ps, {Dk}]")
    if Dk % 8 or v_dim % 2 or not 0 < v_dim <= min(Dk, MAX_V_DIM):
        raise ValueError(f"unsupported geometry Dk={Dk} v_dim={v_dim}")
    if not k_pages.is_contiguous() or k_pages.data_ptr() % 16:
        raise ValueError("the page view must be contiguous, on a 16-byte boundary")
    dev = q.device
    for t in (k_pages, page_tables, ctx_lens):
        if t.device != dev:
            raise ValueError("mla_paged_attention operands must be on one device")
    ps, P = k_pages.shape[1], page_tables.shape[1]
    q = q.contiguous()
    pt = page_tables.to(torch.int32).contiguous()
    cl = ctx_lens.to(torch.int32).contiguous()
    qm = None if causal or Q == 1 else qmask.to(torch.uint8).contiguous()
    out = torch.empty((B, Q, H, v_dim), dtype=q.dtype, device=dev)
    lib = _build.library("mla_attention")
    fn = lib.mla_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    err = fn(q.data_ptr(), k_pages.data_ptr(), pt.data_ptr(), cl.data_ptr(),
             _build.ptr(qm), out.data_ptr(), B, Q, H, Dk, v_dim, ps, P, float(scale),
             int(causal), _build.stream_of(q))
    _build.check(lib, err, "mla_attention")
    mla_paged_attention.launches += 1
    kind = "decode" if Q == 1 else ("prefill" if causal else "verify")
    mla_paged_attention.modes[kind] += 1
    return out


def mla_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                        page_tables: torch.Tensor, ctx_lens: torch.Tensor,
                        qmask: Optional[torch.Tensor], scale: float, v_dim: int,
                        causal: bool = False) -> torch.Tensor:
    """Latent MQA: q [B, Q, H, Dk] (absorbed q_nope | roped q_pe) over one
    layer's pages [n_pages, ps, Dk], whose in-step rows must already be
    written at ctx..ctx+Q-1. ``qmask`` [B, Q, Q] is the in-step visibility;
    ``causal`` takes the causal rule instead (prefill; qmask may be None).
    Returns [B, Q, H, v_dim]."""
    if q.is_cuda:
        return _launch(q, k_pages, page_tables, ctx_lens, qmask, scale, v_dim, causal)
    if q.device.type != "cpu":
        raise NotImplementedError(f"mla_paged_attention on {q.device}")
    if causal:
        B, Q = q.shape[:2]
        qmask = causal_qmask(Q, q.device)[None].expand(B, Q, Q)
    return mla_paged_attention_plain(q, k_pages, page_tables, ctx_lens, qmask, scale,
                                     v_dim)


mla_paged_attention.launches = 0
mla_paged_attention.modes = collections.Counter()
