"""Linear-attention hybrid decoders (the Ring / Bailing-linear class).

Port of ``painlessinferenceacceleration_tpu/models/linear_attn.py``. Every
``layer_group_size``-th layer is full (softmax) attention over the paged
arena; the others are linear attention with a per-head decay ``lam`` and a
recurrent state ``S`` [H, D, D] kept per engine slot in ``kv["s"]``
[n_linear_layers, max_concurrency, H, D, D] (fp32). From
``moe_layer_start`` on, linear and full layers alike take the MoE MLP.
Parameters are the JAX package's: ``params["hybrid_layers"]`` is a list of
per-layer dicts (the irregular interleave does not stack).

A linear layer's q / k / v come from one GEMM, q and k take a per-head
RMSNorm and rope (``linear_qk_norm``, ``linear_rope``) before the silu
feature map, the decay is clipped to [1e-4, 1 - 1e-6], and the output
passes a gated grouped RMSNorm (one group per head) before ``wo``. The
attention itself is K14 (``ops/linear_attention.py``) in one of its modes:

- a prefill chunk (C > 1): the chunkwise form, the state updated in place;
- AR decode (C = 1): one per-token step, the state updated in place;
- lookahead verify (``defer_state``): the per-token step walked down the
  draft tree, no state written; the window's k and v go to the stash
  ``kv["_win"]`` and ``commit_linear_states`` replays the accepted chain
  into the states afterwards, with the same step.

Decode, verify and commit thus share one per-token arithmetic, so lookahead
reproduces AR's rows and states bit for bit. The JAX package verifies and
commits with closed forms that agree with its decode only in exact
arithmetic; the port's results differ from it by that association.

Under a ``DistLLM`` the states ``s`` are whole on every rank. Context
parallelism splits only the full layers' KV pages (``models/base.py
_attn_block_at``); every rank runs the linear layers whole over the
replicated states and commits them alike. Data parallelism splits the
rows: each data group runs its rows' linear layers over its slots'
states, and after the step (after a verify's commit) ``share_slot_states``
writes every group's changed slots on every rank, so ``s`` stays the same
on every group as the replayed K / V rows keep the arena the same.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from painlessinferenceacceleration_tpu_torch._build import resolve_device
from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.layers.embedding import embed_lookup
from painlessinferenceacceleration_tpu_torch.layers.linear import (
    QuantSpec,
    linear,
    make_linear,
)
from painlessinferenceacceleration_tpu_torch.models.base import (
    _attn_block_at,
    _check_model,
    _mlp_block_at,
)
from painlessinferenceacceleration_tpu_torch.models.moe import init_moe_layer, moe_block
from painlessinferenceacceleration_tpu_torch.ops.linear_attention import (
    linear_attention_chunk,
    linear_attention_commit,
    linear_attention_decode,
    linear_attention_tree,
)
from painlessinferenceacceleration_tpu_torch.ops.rmsnorm import (
    rms_group_norm_sigmoid,
    rms_norm,
)
from painlessinferenceacceleration_tpu_torch.ops.rope import apply_rope, dense_cos_sin
from painlessinferenceacceleration_tpu_torch.parallel import comm
from painlessinferenceacceleration_tpu_torch.parallel.comm import linear_rows

DECAY_CLIP = (1e-4, 1.0 - 1e-6)


def n_linear_layers(cfg: ModelConfig) -> int:
    g = cfg.layer_group_size
    L = cfg.num_hidden_layers
    if g <= 0:
        return L
    return L - L // g  # every g-th layer (index % g == g - 1) is full attention


def is_full_layer(cfg: ModelConfig, li: int) -> bool:
    g = cfg.layer_group_size
    return g > 0 and (li % g) == g - 1


def default_decays(H: int, device=None) -> torch.Tensor:
    """Retention-style per-head decay ladder: lam_h = 1 - 2^(-5 - 3h/(H-1))."""
    h = torch.arange(H, dtype=torch.float32, device=device)
    return 1.0 - torch.exp2(-5.0 - 3.0 * h / max(H - 1, 1))


def _normal(generator: torch.Generator, dtype, dev):
    """Draws of std 0.02 on the generator's device, moved to ``dev``."""
    def w(*shape):
        return (torch.randn(*shape, generator=generator, device=generator.device)
                * 0.02).to(device=dev, dtype=dtype)
    return w


def init_linear_layer(cfg: ModelConfig, generator: torch.Generator, dtype,
                      spec: Optional[QuantSpec], device=None, mlp: bool = True) -> dict:
    """A linear-attention layer's weights (std 0.02; norms 1; the default
    decay ladder). ``mlp`` False leaves out the dense MLP (an MoE layer)."""
    E, H, D, I = (cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim,
                  cfg.intermediate_size)
    dev = generator.device if device is None else device
    w = _normal(generator, dtype, dev)
    p = {
        "input_ln": torch.ones(E, dtype=dtype, device=dev),
        "post_ln": torch.ones(E, dtype=dtype, device=dev),
        "wqkv": make_linear(w(E, 3 * H * D), spec),  # no GQA: k and v have H heads
        "w_gate": make_linear(w(E, H * D), spec),
        "out_norm": torch.ones(H * D, dtype=dtype, device=dev),
        "decay": default_decays(H, dev),
        "wo": make_linear(w(H * D, E), spec),
    }
    if mlp:
        p["wgu"] = make_linear(w(E, 2 * I), spec)
        p["wdown"] = make_linear(w(I, E), spec)
    if cfg.linear_qk_norm:
        p["q_norm"] = torch.ones(D, dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(D, dtype=dtype, device=dev)
    return p


def _full_layer(cfg: ModelConfig, generator: torch.Generator, dtype, spec, dev,
                mlp: bool) -> dict:
    E, H, Hk, D, I = (cfg.hidden_size, cfg.num_attention_heads,
                      cfg.num_key_value_heads, cfg.head_dim, cfg.intermediate_size)
    w = _normal(generator, dtype, dev)
    p = {
        "input_ln": torch.ones(E, dtype=dtype, device=dev),
        "post_ln": torch.ones(E, dtype=dtype, device=dev),
        "wqkv": make_linear(w(E, (H + 2 * Hk) * D), spec),
        "wo": make_linear(w(H * D, E), spec),
    }
    if mlp:
        p["wgu"] = make_linear(w(E, 2 * I), spec)
        p["wdown"] = make_linear(w(I, E), spec)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(D, dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(D, dtype=dtype, device=dev)
    return p


def init_hybrid_params(cfg: ModelConfig, generator: torch.Generator,
                       dtype=torch.bfloat16, device=None,
                       quant: Optional[QuantSpec] = None) -> dict:
    """Random (std 0.02) parameters of a hybrid, drawn layer by layer on the
    generator's device: ``hybrid_layers`` (one dict a layer, full or
    linear), where the MoE MLP replaces the dense one from
    ``moe_layer_start`` on, the embedding, the final norm and the head."""
    _check_model(cfg)
    dev = resolve_device(device)
    layers = []
    for li in range(cfg.num_hidden_layers):
        moe = cfg.is_moe and li >= cfg.moe_layer_start
        if is_full_layer(cfg, li):
            lp = _full_layer(cfg, generator, dtype, quant, dev, not moe)
        else:
            lp = init_linear_layer(cfg, generator, dtype, quant, dev, not moe)
        if moe:
            lp.update(init_moe_layer(cfg, generator, dtype, quant, dev))
        layers.append(lp)
    E = cfg.hidden_size
    w = _normal(generator, dtype, dev)
    params = {"embed": w(cfg.vocab_size, E), "hybrid_layers": layers,
              "final_ln": torch.ones(E, dtype=dtype, device=dev)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = make_linear(w(E, cfg.vocab_size), quant)
    return params


def loglam_of(decay: torch.Tensor) -> torch.Tensor:
    """log of the clipped per-head decay [H], fp32."""
    return torch.log(decay.to(torch.float32).clamp(*DECAY_CLIP))


def tree_parents(qmask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each node's parent in a verify window from its ancestor-or-self mask
    [B, Q, Q] (nodes in topological order, so a node's parent is its
    latest strict ancestor): -1 for the root, -2 for a dead node."""
    B, Q, _ = qmask.shape
    idx = torch.arange(Q, device=qmask.device)
    strict = qmask.to(torch.bool) & (idx[None, :] < idx[:, None])[None]
    par = torch.where(strict, idx[None, None, :], -1).amax(dim=-1)
    return torch.where(valid.to(torch.bool), par, -2).to(torch.int32)


def linear_attn_block(
    lp: dict,
    cfg: ModelConfig,
    spec: Optional[QuantSpec],
    h: torch.Tensor,  # [B, C, E]
    state: torch.Tensor,  # [B, H, D, D], or one layer's slot arena with slot_ids
    chunk_lens: torch.Tensor,  # [B] valid tokens (chain mode)
    parents: Optional[torch.Tensor] = None,  # [B, C] tree mode (verify)
    valid: Optional[torch.Tensor] = None,  # [B, C] live nodes (tree mode)
    cos: Optional[torch.Tensor] = None,  # rope tables (cfg.linear_rope)
    sin: Optional[torch.Tensor] = None,
    slot_ids: Optional[torch.Tensor] = None,
    par=None,  # the rank's parallel.comm.RankState (None: one process)
):
    """One linear-attention block; returns (out [B, C, E], feats).

    Chain mode (``parents`` None) updates ``state`` in place: the chunkwise
    form for C > 1, the per-token step for C = 1 (rows with
    ``chunk_lens`` 0 untouched); feats is None. Tree mode reads the state
    only and returns the silu'd (k, v) [B, H, C, D] for the commit."""
    B, C, _ = h.shape
    H, D = cfg.num_attention_heads, cfg.head_dim
    qkv = linear(lp["wqkv"], h, spec)
    xq = qkv[..., : H * D].reshape(B, C, H, D)
    xk = qkv[..., H * D: 2 * H * D].reshape(B, C, H, D)
    xv = qkv[..., 2 * H * D:].reshape(B, C, H, D)
    if cfg.linear_qk_norm:
        xq = rms_norm(xq, lp["q_norm"], cfg.rms_norm_eps)
        xk = rms_norm(xk, lp["k_norm"], cfg.rms_norm_eps)
    if cfg.linear_rope and cos is not None:
        # rope before the feature map: the state accumulates rotated keys
        xq, xk = apply_rope(xq, cos, sin), apply_rope(xk, cos, sin)
    xq = F.silu(xq.to(torch.float32)).transpose(1, 2).contiguous()
    xk = F.silu(xk.to(torch.float32)).transpose(1, 2).contiguous()
    xv = xv.to(torch.float32).transpose(1, 2).contiguous()
    loglam = loglam_of(lp["decay"])
    feats = None
    if parents is not None:
        out = linear_attention_tree(xq, xk, xv, state, parents, valid, loglam, slot_ids)
        feats = (xk, xv)
    elif C == 1:
        out, _ = linear_attention_decode(xq, xk, xv, state, chunk_lens[:, None] > 0,
                                         loglam, slot_ids)
    else:
        out, _ = linear_attention_chunk(xq, xk, xv, state, chunk_lens, loglam, slot_ids)
    out = out.transpose(1, 2).reshape(B, C, H * D).to(h.dtype)
    gate = linear(lp["w_gate"], h, spec)
    out = rms_group_norm_sigmoid(out, gate, lp["out_norm"], cfg.rms_norm_eps, H)
    return linear_rows(lp["wo"], out, spec, par, par is None or par.attn_split), feats


def _as_stack(lp: dict) -> dict:
    """A per-layer dict as a one-layer stack (views), for the stacked-layer
    blocks of ``models/base.py``."""
    return {k: (_as_stack(v) if isinstance(v, dict) else v[None]) for k, v in lp.items()}


def hybrid_forward(
    params: dict,
    cfg: ModelConfig,
    kv: dict,
    tokens: torch.Tensor,  # [B, C]
    positions: torch.Tensor,  # [B, C]
    page_tables: torch.Tensor,
    start_lens: torch.Tensor,
    qmask: torch.Tensor,
    valid: Optional[torch.Tensor],
    spec: Optional[QuantSpec],
    slot_ids: Optional[torch.Tensor],
    defer_state: bool = False,
    causal_window: bool = False,
    par=None,  # the rank's parallel.comm.RankState (None: one process)
    record: Optional[list] = None,  # gets (KV layer, K rows, V rows) of each full layer
):
    """Forward over the interleaved linear / full layers; returns (hidden
    [B, C, E], kv updated in place).

    ``defer_state`` (lookahead verify): the window is a draft tree (its
    parents from ``qmask``); no state is written, and the window's k and v
    of every linear layer go to ``kv["_win"]`` (``k``, ``v`` [n_lin, B, H,
    C, D], ``loglam`` [n_lin, H]) for ``commit_linear_states``."""
    B, C = tokens.shape
    dev = tokens.device
    H, D = cfg.num_attention_heads, cfg.head_dim
    h = embed_lookup(params["embed"], tokens, params["final_ln"].dtype)
    cos, sin = dense_cos_sin(cfg, positions)
    if slot_ids is None:
        slot_ids = torch.arange(B, dtype=torch.int32, device=dev)
    if valid is None:
        valid = torch.ones((B, C), dtype=torch.bool, device=dev)
    chunk_lens = valid.sum(dim=1).to(torch.int32)
    parents = tree_parents(qmask, valid) if defer_state else None
    s = kv["s"]
    n_lin = s.shape[0]
    if defer_state:
        win = {"k": torch.empty((n_lin, B, H, C, D), dtype=torch.float32, device=dev),
               "v": torch.empty((n_lin, B, H, C, D), dtype=torch.float32, device=dev),
               "loglam": torch.empty((n_lin, H), dtype=torch.float32, device=dev)}
    full_idx = lin_idx = 0
    for li, lp in enumerate(params["hybrid_layers"]):
        hn = rms_norm(h, lp["input_ln"], cfg.rms_norm_eps)
        if is_full_layer(cfg, li):
            attn_out = _attn_block_at(_as_stack(lp), 0, full_idx, cfg, spec, hn, cos, sin,
                                      kv, page_tables, start_lens, qmask, valid,
                                      causal_window, par=par, record=record)
            full_idx += 1
        else:
            attn_out, feats = linear_attn_block(
                lp, cfg, spec, hn, s[lin_idx], chunk_lens, parents, valid,
                cos if cfg.linear_rope else None, sin if cfg.linear_rope else None,
                slot_ids, par)
            if defer_state:
                win["k"][lin_idx], win["v"][lin_idx] = feats
                win["loglam"][lin_idx] = loglam_of(lp["decay"])
            lin_idx += 1
        h = h + attn_out
        hn = rms_norm(h, lp["post_ln"], cfg.rms_norm_eps)
        if "moe_wgu" in lp:
            h = h + moe_block(lp, cfg, spec, hn, par)
        else:
            h = h + _mlp_block_at(_as_stack(lp), 0, cfg, spec, hn, par)
    if defer_state:
        kv["_win"] = win
    return h, kv


def commit_linear_states(kv: dict, chain: torch.Tensor, n_commit: torch.Tensor,
                         slot_ids: torch.Tensor, par=None) -> dict:
    """Fold the accepted chain into the recurrent states after a verify:
    pops the ``"_win"`` stash of ``hybrid_forward(defer_state=True)`` and
    replays, for each row, the window columns ``chain[b, :n_commit[b]]``
    (the root first) into slot ``slot_ids[b]`` of every linear layer, with
    the per-token step (K14 commit mode). Rows with ``n_commit`` 0 (inactive,
    padding) write nothing. Under data parallelism (a rank state ``par``
    whose ``dp`` > 1) the stash holds this group's block of rows
    (``parallel.comm.data_block``): those are committed, then every group's
    committed slots are shared (``share_slot_states``)."""
    win = kv.pop("_win")
    if par is None or par.dp == 1:
        linear_attention_commit(kv["s"], win["k"], win["v"], chain, n_commit, win["loglam"],
                                slot_ids)
        return kv
    a, n, bmax, _ = comm.data_block(chain.shape[0], par)
    linear_attention_commit(kv["s"], win["k"], win["v"], comm.block_rows(chain, a, n, bmax),
                            comm.block_rows(n_commit, a, n, bmax, "zeros"), win["loglam"],
                            comm.block_rows(slot_ids, a, n, bmax))
    share_slot_states(kv, slot_ids, n_commit > 0, par)
    return kv


def share_slot_states(kv: dict, slot_ids: torch.Tensor, changed: torch.Tensor, par) -> None:
    """Data parallelism: after a step each data group has changed the
    states of its own rows' slots. Every group's states of its block's slots
    are gathered in group order (one exact gather of [n_lin, rows, H, D, D]
    fp32) and each rank writes the other groups' changed slots (``changed``
    [B] bool: a padding or inactive row, whose slot may be another row's,
    writes nothing), so ``kv["s"]`` holds the same bits on every group."""
    s = kv["s"]
    a, n, bmax, sizes = comm.data_block(slot_ids.shape[0], par)
    mine = s[:, comm.block_rows(slot_ids, a, n, bmax).long()]
    parts = comm.data_gather(mine.contiguous(), par)
    start = 0
    for g, size in enumerate(sizes):
        if g != par.data_rank:
            ok = changed[start:start + size]
            slots = slot_ids[start:start + size][ok].long()
            s[:, slots] = parts[g][:, :size][:, ok]
        start += size
