"""Paged attention over the bf16 KV arena: kernel wrappers and plain versions.

``paged_attention`` (decode and tree verify, 1 <= Q <= 128) replaces the
Pallas ``_attn_decode_kernel`` and ``_attn_verify_kernel``;
``paged_attention_prefill`` (causal, Q > 128) replaces
``_attn_prefill_kernel`` (``painlessinferenceacceleration_tpu/ops/
paged_attention.py``). Both launch the one kernel of
``csrc/paged_attention.cu``, the second with its causal rule, and only for a
bf16 arena: the static-fp8 arena mode is not ported yet.

The arena argument is one layer's view ``[n_pages, ps, Hkv*D]`` of the
stacked arena (``kv["k"][li]``, no copy). A CPU tensor takes the plain
version (``ops/attention.py``); a CUDA tensor launches the kernel or raises.
Each wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from painlessinferenceacceleration_tpu_torch import _build
from painlessinferenceacceleration_tpu_torch.ops.attention import (
    causal_qmask,
    paged_attention_ref,
)

_ROWS_PER_BLOCK = 64  # csrc/paged_attention.cu kRows


def _launch(q, k_pages, v_pages, page_tables, ctx_lens, qmask, scale, causal):
    B, Q, Hq, D = q.shape
    n_pages, ps, HD = k_pages.shape
    Hkv = HD // D
    P = page_tables.shape[1]
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16 \
            or v_pages.dtype != torch.bfloat16:
        raise TypeError("paged_attention kernels take bf16 q and a bf16 arena")
    if D not in (64, 128) or ps % 8 or ps > 128 or Hq % Hkv \
            or _ROWS_PER_BLOCK % (Hq // Hkv):
        raise ValueError(f"unsupported geometry Hq={Hq} Hkv={Hkv} D={D} ps={ps}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("the arena views must be contiguous")
    dev = q.device
    for t in (k_pages, v_pages, page_tables, ctx_lens):
        if t.device != dev:
            raise ValueError("paged_attention operands must be on one device")
    q = q.contiguous()
    pt = page_tables.to(torch.int32).contiguous()
    cl = ctx_lens.to(torch.int32).contiguous()
    qm = None if causal else qmask.to(torch.uint8).contiguous()
    out = torch.empty_like(q)
    lib = _build.library("paged_attention")
    fn = lib.paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             pt.data_ptr(), cl.data_ptr(), _build.ptr(qm), out.data_ptr(),
             B, Q, Hq, Hkv, D, ps, P, float(scale), int(causal),
             _build.stream_of(q))
    _build.check(lib, err, "paged_attention")
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_tables: torch.Tensor,
                    ctx_lens: torch.Tensor, qmask: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Decode / tree-verify attention, q [B, Q, Hq, D] with Q <= 128.

    K/V of the Q in-step tokens must already be written at ctx..ctx+Q-1."""
    if q.is_cuda:
        if q.shape[1] > 128:
            raise ValueError("paged_attention serves Q <= 128; use the prefill kernel")
        out = _launch(q, k_pages, v_pages, page_tables, ctx_lens, qmask, scale,
                      causal=False)
        paged_attention.launches += 1
        return out
    if q.device.type != "cpu":
        raise NotImplementedError(f"paged_attention on {q.device}")
    return paged_attention_ref(q, k_pages, v_pages, page_tables, ctx_lens,
                               qmask, scale)


def paged_attention_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_tables: torch.Tensor,
                            ctx_lens: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal chunk attention over K/V already written at ctx..ctx+Q-1.

    Rows past a request's valid tokens give finite values that callers
    discard, as in the JAX package."""
    if q.is_cuda:
        out = _launch(q, k_pages, v_pages, page_tables, ctx_lens, None, scale,
                      causal=True)
        paged_attention_prefill.launches += 1
        return out
    if q.device.type != "cpu":
        raise NotImplementedError(f"paged_attention_prefill on {q.device}")
    B, Q = q.shape[:2]
    qmask = causal_qmask(Q, q.device)[None].expand(B, Q, Q)
    return paged_attention_ref(q, k_pages, v_pages, page_tables, ctx_lens,
                               qmask, scale)


paged_attention.launches = 0
paged_attention_prefill.launches = 0
