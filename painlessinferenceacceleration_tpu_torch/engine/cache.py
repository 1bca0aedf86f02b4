"""Paged KV arena (bf16/fp32, or e4m3 with scales), updated in place.

Port of ``painlessinferenceacceleration_tpu/engine/cache.py``. The layout is
the JAX package's data contract: ``[n_layers, n_pages, page_size,
n_kv_heads * head_dim]``, token-major with the heads folded into the last
axis, and page 0 reserved as the null page that padded page-table entries
and invalid tokens point at. Three arena kinds (``EngineConfig.kv_quant``):

- ``"none"``: K/V in the model's dtype;
- ``"fp8"``: e4m3 K/V with static per-(layer, kv head) f32 scales
  ``k_scale``/``v_scale`` [L, Hkv]; a write divides by the scale and clips
  to +-448 before the cast (torch's cast does not saturate);
- ``"fp8_tok"``: e4m3 K/V with per-(token, kv head) f32 scales
  ``k_tok_scale``/``v_tok_scale`` [L, n_pages, ps, Hkv], amax/448 of each
  written row. The JAX package pads the head axis to 128 lanes for its DMA
  tiles; the port does not (``models/convert.py`` drops the padding).

An MLA model (``ModelConfig.is_mla``) has an arena of its own shape, in the
model's dtype whatever ``kv_quant`` says (as the JAX package allocates it):
per-head K rows of nope + rope lanes and V rows of v_head_dim lanes
(expanded mode), or one shared row per token (latent mode): K =
``[latent | roped k_pe]``, ``kv_lora_rank + qk_rope_head_dim`` lanes, and V =
the latent again, ``kv_lora_rank`` lanes. The JAX package pads the latent K
row to a multiple of 128 lanes for its page DMA; the port does not.

A linear-attention hybrid (``ModelConfig.linear_attention``) has K/V arenas
for its full-attention layers only (at least one), in the model's dtype,
and the recurrent-state arena ``s`` [n_linear_layers, max_concurrency, H, D,
D] in fp32, one state per engine slot. The JAX package allocates no scale
arrays for a hybrid, so it never holds e4m3 pages; here ``kv_quant`` other
than ``"none"`` raises for one.

e4m3 rows are scattered and gathered through ``uint8`` views. JAX donates
the arena and gets an updated copy back; here every writer updates the
tensors in place and also returns them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from painlessinferenceacceleration_tpu_torch._build import resolve_device
from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
    FP8,
    kv_compact_tail,
    kv_move_rows,
    kv_write_step,
)


def kv_cache_shape(mcfg: ModelConfig, ecfg: EngineConfig) -> Tuple[int, ...]:
    return (
        mcfg.num_hidden_layers,
        ecfg.num_pages,
        ecfg.page_size,
        mcfg.num_key_value_heads * mcfg.head_dim,
    )


def _mla_rows(mcfg: ModelConfig) -> Tuple[int, int]:
    """(K row, V row) lanes of an MLA arena."""
    from painlessinferenceacceleration_tpu_torch.models.mla import (
        mla_cache_heads,
        mla_head_dims,
    )

    dk, dv = mla_head_dims(mcfg)
    H = mla_cache_heads(mcfg)
    return H * dk, H * dv


def kv_bytes_per_page(mcfg: ModelConfig, ecfg: EngineConfig,
                      dtype=torch.bfloat16) -> int:
    """Bytes one KV page costs across all layers, K and V (and scales). An
    MLA arena is counted at ``dtype``'s size, the type it is allocated in
    (the JAX package counts 1 byte under ``kv_quant="fp8"``)."""
    fp8 = ecfg.kv_quant.startswith("fp8")
    dtype_size = torch.empty((), dtype=dtype).element_size()
    L, ps, Hk = mcfg.num_hidden_layers, ecfg.page_size, mcfg.num_key_value_heads
    if mcfg.linear_attention:  # the full layers' pages only
        return _n_full(mcfg) * ps * Hk * mcfg.head_dim * dtype_size * 2
    if mcfg.is_mla:
        return L * ps * sum(_mla_rows(mcfg)) * dtype_size
    itemsize = 1 if fp8 else dtype_size
    base = L * ps * Hk * mcfg.head_dim * itemsize * 2
    if ecfg.kv_quant == "fp8_tok":
        base += L * ps * Hk * 4 * 2  # f32 per-token scale rows (k + v)
    return base


def _n_full(mcfg: ModelConfig) -> int:
    """KV layers of a hybrid: its full-attention layers (at least one)."""
    from painlessinferenceacceleration_tpu_torch.models.linear_attn import n_linear_layers

    return max(mcfg.num_hidden_layers - n_linear_layers(mcfg), 1)


def auto_size_pages(mcfg: ModelConfig, ecfg: EngineConfig, dtype=torch.bfloat16,
                    device=None) -> int:
    """Pages that fit ``ecfg.cache_memory_fraction`` of the card's free
    memory (queried after the parameters are resident), capped by what
    max_concurrency can ever address. Off the card: the default sizing."""
    default = ecfg.max_concurrency * ecfg.pages_per_req + 1
    dev = resolve_device(device)
    if dev.type != "cuda":
        return default
    free, _ = torch.cuda.mem_get_info(dev)
    n = int(free * ecfg.cache_memory_fraction) // kv_bytes_per_page(mcfg, ecfg, dtype)
    return max(2, min(int(n), default))


def init_kv_cache(mcfg: ModelConfig, ecfg: EngineConfig,
                  dtype=torch.bfloat16, device=None) -> dict:
    """Allocate the zeroed arena of ``ecfg.kv_quant``'s kind on ``device``
    (default cuda); an MLA model's arena is always in ``dtype``."""
    dev = resolve_device(device)
    if mcfg.linear_attention:
        if ecfg.kv_quant != "none":
            raise ValueError(f"kv_quant={ecfg.kv_quant!r}: a linear-attention hybrid's "
                             "arena holds no e4m3 pages")
        from painlessinferenceacceleration_tpu_torch.models.linear_attn import (
            n_linear_layers,
        )

        shape = (_n_full(mcfg), ecfg.num_pages, ecfg.page_size,
                 mcfg.num_key_value_heads * mcfg.head_dim)
        H, D = mcfg.num_attention_heads, mcfg.head_dim
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "s": torch.zeros((n_linear_layers(mcfg), ecfg.max_concurrency, H, D, D),
                                 dtype=torch.float32, device=dev)}
    if mcfg.is_mla:
        if ecfg.kv_quant == "fp8_tok":
            raise ValueError("kv_quant='fp8_tok' supports the dense stacked-layer "
                             "family only")
        k_row, v_row = _mla_rows(mcfg)
        base = (mcfg.num_hidden_layers, ecfg.num_pages, ecfg.page_size)
        return {"k": torch.zeros(base + (k_row,), dtype=dtype, device=dev),
                "v": torch.zeros(base + (v_row,), dtype=dtype, device=dev)}
    shape = kv_cache_shape(mcfg, ecfg)
    if ecfg.kv_quant == "none":
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
    kv = {"k": torch.zeros(shape, dtype=FP8, device=dev),
          "v": torch.zeros(shape, dtype=FP8, device=dev)}
    Hk = mcfg.num_key_value_heads
    if ecfg.kv_quant == "fp8_tok":
        for name in ("k_tok_scale", "v_tok_scale"):
            kv[name] = torch.zeros(shape[:3] + (Hk,), dtype=torch.float32, device=dev)
    else:  # "fp8"
        for name in ("k_scale", "v_scale"):
            kv[name] = torch.full((shape[0], Hk), ecfg.kv_scale_init,
                                  dtype=torch.float32, device=dev)
    return kv


def reset_linear_states(kv: dict, slots) -> dict:
    """Zero the recurrent states of the engine slots ``slots`` (a new
    request taking a slot starts from an empty state); a no-op for an
    arena without states."""
    if "s" in kv and len(slots):
        idx = torch.as_tensor(list(slots), dtype=torch.long).to(kv["s"].device)
        kv["s"].index_fill_(1, idx, 0.0)
    return kv


def write_kv_pages(
    k_pages: torch.Tensor,  # [L, n_pages, ps, H*D]
    v_pages: torch.Tensor,
    new_k: torch.Tensor,  # [B, Q, H, D]
    new_v: torch.Tensor,  # [B, Q, H, Dv]
    page_tables: torch.Tensor,  # [B, P]
    start_lens: torch.Tensor,  # [B]
    valid: Optional[torch.Tensor] = None,  # [B, Q]; invalid -> null page
    layer: int = 0,
    k_scale: Optional[torch.Tensor] = None,  # [H] static e4m3 scales (this layer)
    v_scale: Optional[torch.Tensor] = None,
    k_tok_scale: Optional[torch.Tensor] = None,  # [L, n_pages, ps, H] (fp8_tok)
    v_tok_scale: Optional[torch.Tensor] = None,
):
    """Scatter the step's K/V rows of layer ``layer`` into the arena, in
    place (quantizing them for an e4m3 arena). Token q of request b lands at
    slot ``start_lens[b] + q``, its page index clamped to the table's last.
    On the card: one ``kv_write_step`` launch for K, V and (fp8_tok) their
    scale rows, which reads these tensors as they come; an invalid token
    writes nothing. On the CPU: the eager route (``kv_step_rows``, then the
    row scatter), where invalid tokens go to the null page 0, the last one
    written kept. Returns the arenas written (with the scale arenas in
    fp8_tok mode)."""
    arenas = (k_pages, v_pages)
    if k_tok_scale is not None:
        arenas += (k_tok_scale, v_tok_scale)
    return kv_write_step(arenas, new_k, new_v, page_tables, start_lens, valid, layer,
                         k_scale, v_scale)


def gather_kv_pages(pages: torch.Tensor, page_tables: torch.Tensor,
                    head_dim: int, scale: Optional[torch.Tensor] = None,
                    out_dtype=None) -> torch.Tensor:
    """One layer's pages [n_pages, ps, H*D] -> dense [B, H, P*ps, D].

    An e4m3 arena is dequantized in fp32 with ``scale``: static per-head
    [H] or the layer's per-token arena [n_pages, ps, H]. ``out_dtype``
    defaults to the arena's type (fp32 for e4m3)."""
    pt = page_tables.long()
    fp8 = pages.dtype == FP8
    g = pages.view(torch.uint8)[pt].view(FP8) if fp8 else pages[pt]  # [B, P, ps, H*D]
    B, P, S, HD = g.shape
    H = HD // head_dim
    g = g.reshape(B, P, S, H, head_dim).permute(0, 3, 1, 2, 4)
    g = g.reshape(B, H, P * S, head_dim)
    if fp8:
        if scale.dim() == 3:  # per-token [n_pages, ps, H]
            sc = scale[pt].permute(0, 3, 1, 2).reshape(B, H, P * S, 1)
        else:  # static per-head [H]
            sc = scale[None, :, None, None]
        g = g.to(torch.float32) * sc
    return g if out_dtype is None else g.to(out_dtype)


def compact_kv_tail(
    pages,  # [L, n_pages, ps, row], or a tuple of up to four such arenas
    page_tables: torch.Tensor,  # [B, P]
    ctx_lens: torch.Tensor,  # [B]
    path: torch.Tensor,  # [B, M] accepted in-step node offsets
    n_edges: torch.Tensor,  # [B] accepted edges (moves)
    q_width: int,  # verify width Q (tail window = [ctx, ctx+Q))
    active: Optional[torch.Tensor] = None,  # [B]; inactive rows -> null page
):
    """Lookahead KV compaction of each request's tail window, in place over
    all layers: node (ctx + path[i]) moves to slot (ctx + 1 + i) for
    i < n_edges. ``pages`` is one arena or a tuple of arenas that share the
    tables (K and V, and fp8_tok's K and V scale arenas); returns it.

    Every arena kind (bf16, fp32, e4m3 and the f32 scale rows) is permuted
    in place, all of the arenas in one launch that derives the windows from
    these tensors itself (``kv_compact_tail``). The JAX package takes
    another route for e4m3 and scale arenas: it gathers each window's rows
    from their sources and writes the window's pages back whole
    (``kv_write_pages``). The bytes are the same outside the null page 0,
    since every slot of a window page outside the moves is its own
    source."""
    kv_compact_tail(pages if isinstance(pages, tuple) else (pages,), page_tables, ctx_lens,
                    path, n_edges, q_width, active)
    return pages


def move_kv_rows(pages: torch.Tensor, page_tables: torch.Tensor, src_slots: torch.Tensor,
                 dst_slots: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Move each request's rows at ``src_slots`` to ``dst_slots`` [B, M]
    over all layers, in place (``kv_move_rows``); moves with ``valid`` False
    write into the null page. Every source is read before any destination
    is written, so a chain of moves reads the rows as they were. Port of the
    JAX package's ``move_kv_rows``, which nothing in that package calls: a
    per-row alternative to ``compact_kv_tail``."""
    ps = pages.shape[2]
    P = page_tables.shape[1]
    pt = page_tables.long()
    src, dst = src_slots.long(), dst_slots.long()
    sp = torch.gather(pt, 1, (src // ps).clamp(0, P - 1))
    dp = torch.gather(pt, 1, (dst // ps).clamp(0, P - 1))
    dp = torch.where(valid, dp, torch.zeros_like(dp))
    return kv_move_rows(pages, sp.reshape(-1), (src % ps).reshape(-1), dp.reshape(-1),
                        (dst % ps).reshape(-1))
