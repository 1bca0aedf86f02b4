"""Rank grids and each rank's shard of the parameters and of the KV arena.

Port of ``painlessinferenceacceleration_tpu/parallel/mesh.py``. Axes:
``data`` splits the batch's rows, ``model`` the heads and the MLP's
intermediate width (tensor parallelism), the experts (with
``cfg.expert_parallel``) or the KV pages (context parallelism, where the
parameters are replicated). The leaf table is the JAX package's:
projections into head / expert / hidden space are column-parallel, the
projections back row-parallel, their biases follow, everything else is
replicated.

Where JAX keeps the global computation whatever the layout (GSPMD), a rank
here computes on its own shard, so each split follows the meaning of its
leaf:
- a fused leaf splits part by part: ``wqkv`` into this rank's q, k and v
  heads, re-fused; ``wgu`` into its gate and its up columns; ``bqkv`` and
  ``bgu`` as their weights;
- a quantized leaf ``{"q", "s", ...}`` splits on its scale groups (packed
  int4 holds two K rows a byte, a group's rows together), block-fp8 on its
  128-blocks; other extra leaves (a static activation scale) are
  replicated;
- a width that does not divide splits as evenly as its units go (86 int4
  groups over 4 ranks: 22, 22, 21, 21), with no padding;
- each rank serves a rank-local ``ModelConfig`` (its heads, KV heads and
  intermediate widths), so the blocks and ``init_kv_cache`` size
  everything by the shard.
Where heads do not divide, the attention is replicated as the JAX KV
arena is (``kv_shardings``): KV heads fewer than ranks are duplicated, one
a rank, when the ranks divide by them; otherwise every rank computes the
whole attention. A shard that a kernel would refuse raises here, naming
the leaf.

Placements are named by class: ``col`` (last axis), ``row`` (second to
last), ``expert`` (the expert axis), ``heads`` (the KV arena's trailing
head axis, the linear state's head axis), ``pages`` (the arena's page
axis) and ``replicated``. Where the port differs from the JAX table on
purpose: the embedding is replicated (JAX splits its E axis), and a
linear-attention layer's ``out_norm`` and ``decay`` follow their heads
(JAX replicates them and GSPMD slices).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.parallel.comm import split_sizes

COL_LEAVES = frozenset({"wqkv", "wgu", "wq", "q_b", "kv_b", "moe_wgu", "shared_wgu",
                        "w_gate", "lm_head"})
ROW_LEAVES = frozenset({"wo", "wdown", "moe_wdown", "shared_wdown"})
COL_BIAS_LEAVES = frozenset({"bqkv", "bgu"})
HEAD_LEAVES = frozenset({"out_norm", "decay"})  # linear attention, per head
EXPERT_LEAVES = frozenset({"moe_wgu", "moe_wdown"})
# the leaves of each block, replicated where the plan does not split it
ATTN_LEAVES = frozenset({"wqkv", "bqkv", "wq", "q_b", "kv_b", "w_gate", "wo"}) | HEAD_LEAVES
MLP_LEAVES = frozenset({"wgu", "bgu", "wdown"})
SHARED_LEAVES = frozenset({"shared_wgu", "shared_wdown"})


class Mesh:
    """A grid of ranks. ``shape`` maps each axis to its size (as a JAX
    mesh's); the last axis is ``model``, the others together are the data
    axis. ``model_group`` / ``data_group`` are this rank's process groups
    along them (None where the axis has one rank)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], rank: int,
                 model_group=None, data_group=None):
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, (int(s) for s in shape)))
        self.tp = int(shape[-1])
        self.dp = math.prod(int(s) for s in shape[:-1])
        self.rank = rank
        self.model_index = rank % self.tp
        self.data_index = rank // self.tp
        self.model_group = model_group
        self.data_group = data_group


def make_mesh(shape: Optional[Sequence[int]] = None,
              axes: Sequence[str] = ("data", "model")) -> Mesh:
    """The rank grid over the joined process group (one rank when none is
    joined): ``shape`` (data, model), default (1, world). Rank r sits at
    data index r // model and model index r % model; every rank takes part
    in creating every axis group, as ``torch.distributed.new_group``
    asks."""
    import torch.distributed as dist

    on = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if on else (1, 0)
    shape = tuple(shape) if shape is not None else (1, world)
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh {shape} over axes {tuple(axes)} for {world} rank(s)")
    tp = shape[-1]
    dp = world // tp
    model_group = data_group = None
    if on and world > 1:
        for d in range(dp):
            ranks = [d * tp + m for m in range(tp)]
            g = dist.new_group(ranks) if tp > 1 else None
            if rank in ranks:
                model_group = g
        for m in range(tp):
            ranks = [d * tp + m for d in range(dp)]
            g = dist.new_group(ranks) if dp > 1 else None
            if rank in ranks:
                data_group = g
    return Mesh(shape, axes, rank, model_group, data_group)


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How one model splits over ``tp`` model ranks (``mode`` "tp", "ep" or
    "cp"; under "cp" nothing splits). Ranges are per rank."""

    tp: int
    mode: str
    attn: str  # "split" | "kv_dup" | "replicated"
    q_heads: Tuple[Tuple[int, int], ...]
    kv_heads: Tuple[Tuple[int, int], ...]
    mlp: Optional[Tuple[Tuple[int, int], ...]]  # dense intermediate columns
    moe: Optional[Tuple[Tuple[int, int], ...]]  # each expert's columns
    shared: Optional[Tuple[Tuple[int, int], ...]]  # the shared experts' columns
    experts: Optional[Tuple[Tuple[int, int], ...]]  # expert ranges under "ep"
    head: Optional[Tuple[Tuple[int, int], ...]]  # LM head vocabulary columns


def _ranges(sizes: Sequence[int], unit: int = 1) -> Tuple[Tuple[int, int], ...]:
    out, a = [], 0
    for s in sizes:
        out.append((a * unit, (a + s) * unit))
        a += s
    return tuple(out)


def _k_of(leaf) -> int:
    """The K (input rows) of one linear leaf, native or quantized."""
    if isinstance(leaf, dict):
        q = leaf["q"]
        return q.shape[-2] * (2 if q.dtype == torch.uint8 else 1)
    return leaf.shape[-2]


def _scale_kind(leaf: dict) -> str:
    """"group" ([.., K/g, N]), "block" ([.., K/128, N/128]) or "channel"
    ([.., N]) scales of a quantized leaf."""
    q, s = leaf["q"], leaf["s"]
    if s.dim() == q.dim() - 1:
        return "channel"
    return "group" if s.shape[-1] == q.shape[-1] else "block"


def row_unit(leaf) -> int:
    """The rows a split of ``leaf``'s K must keep together: its scale
    group, a 128-block, 16 rows for a per-channel 8-bit leaf (the W8A8
    kernels take K % 16 == 0), 8 for a native one (the bf16 GEMM's K %
    8)."""
    K = _k_of(leaf)
    if isinstance(leaf, dict):
        kind = _scale_kind(leaf)
        if kind == "group":
            return K // leaf["s"].shape[-2]
        if kind == "block":
            return 128
        return 16 if K % 16 == 0 else 1
    return 8 if K % 8 == 0 else 1


def col_unit(leaf) -> int:
    """The columns a split of ``leaf``'s N must keep together: a 128-block
    for block-fp8, 16 for a quantized leaf, 8 for a native one (where N
    allows)."""
    N = leaf["q"].shape[-1] if isinstance(leaf, dict) else leaf.shape[-1]
    if isinstance(leaf, dict) and _scale_kind(leaf) == "block":
        return 128
    for u in ((16, 8) if isinstance(leaf, dict) else (8,)):
        if N % u == 0:
            return u
    return 1


def _width_split(width: int, unit: int, tp: int):
    """Ranges of ``width`` cut in ``unit``s over ``tp`` ranks, or None
    when there are fewer units than ranks (the block is replicated)."""
    if width % unit or width // unit < tp:
        return None
    return _ranges(split_sizes(width // unit, tp), unit)


def _stacks(params: dict) -> List[dict]:
    """Every layer stack of ``params``: ``layers``, ``moe_layers`` and each
    of a hybrid's per-layer dicts."""
    out = [params[k] for k in ("layers", "moe_layers") if k in params]
    out.extend(params.get("hybrid_layers", ()))
    return out


def shard_mode(cfg: ModelConfig) -> str:
    """What the model axis splits: the KV pages ("cp") under
    ``cfg.context_parallel``, the experts ("ep") of an MoE model under
    ``cfg.expert_parallel``, else the heads and widths ("tp")."""
    if cfg.context_parallel:
        return "cp"
    return "ep" if cfg.expert_parallel and cfg.is_moe else "tp"


def plan_shards(cfg: ModelConfig, tp: int, params: dict) -> ShardPlan:
    """The split of ``params`` (of ``cfg``) over ``tp`` model ranks."""
    mode = shard_mode(cfg)
    H, Hk = cfg.num_attention_heads, cfg.num_key_value_heads
    one = ((0, H),) * tp, ((0, Hk),) * tp
    if mode == "cp" or tp == 1:
        return ShardPlan(tp, mode, "replicated", *one, None, None, None, None, None)
    attn = "replicated"
    q_heads, kv_heads = one
    if H % tp == 0:
        q_heads = _ranges([H // tp] * tp)
        if cfg.is_mla or Hk % tp == 0:
            attn = "split"
            kv_heads = q_heads if cfg.is_mla else _ranges([Hk // tp] * tp)
        elif tp % Hk == 0:
            attn = "kv_dup"
            kv_heads = tuple((r // (tp // Hk), r // (tp // Hk) + 1) for r in range(tp))
        else:
            q_heads = one[0]
    stacks = _stacks(params)

    def split_of(key):
        for st in stacks:
            if key in st:
                leaf = st[key]
                return _width_split(_k_of(leaf), row_unit(leaf), tp)
        return None

    experts = None
    if mode == "ep":
        X = cfg.num_experts
        if X % tp:
            raise ValueError(f"expert parallelism over {tp} ranks needs the experts ({X}) "
                             "to divide")
        experts = _ranges([X // tp] * tp)
    head = None
    if isinstance(params.get("lm_head"), (torch.Tensor, dict)):
        lm = params["lm_head"]
        N = lm["q"].shape[-1] if isinstance(lm, dict) else lm.shape[-1]
        head = _width_split(N, col_unit(lm), tp)
    return ShardPlan(tp, mode, attn, q_heads, kv_heads, split_of("wdown"),
                     None if mode == "ep" else split_of("moe_wdown"),
                     split_of("shared_wdown"), experts, head)


def rank_config(cfg: ModelConfig, plan: ShardPlan, rank: int) -> ModelConfig:
    """The rank-local ``ModelConfig``: its heads, KV heads and intermediate
    widths (the head dim made explicit); under "cp" the config with
    ``context_parallel`` set."""
    if plan.mode == "cp":
        return dataclasses.replace(cfg, context_parallel=True)
    (h0, h1), (k0, k1) = plan.q_heads[rank], plan.kv_heads[rank]
    kw = dict(num_attention_heads=h1 - h0, num_key_value_heads=k1 - k0,
              head_dim=cfg.head_dim)
    if plan.mlp is not None:
        kw["intermediate_size"] = plan.mlp[rank][1] - plan.mlp[rank][0]
    if plan.moe is not None:
        im = plan.moe[rank][1] - plan.moe[rank][0]
        kw["moe_intermediate_size"] = im
        if plan.mlp is None and not cfg.moe_intermediate_size:
            kw["intermediate_size"] = im
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


def _leaf_class(name: str, leaf, plan: ShardPlan) -> object:
    """The placement class of one layer leaf under ``plan`` (a dict of
    classes for a quantized leaf: q and s follow, other entries are
    replicated)."""
    cls = "replicated"
    if plan.mode == "ep" and name in EXPERT_LEAVES:
        cls = "expert"
    elif ((name in ATTN_LEAVES and plan.attn == "replicated")
          or (name in MLP_LEAVES and plan.mlp is None)
          or (name in EXPERT_LEAVES and plan.moe is None)
          or (name in SHARED_LEAVES and plan.shared is None)
          or (name == "lm_head" and plan.head is None)):
        pass
    elif name in COL_LEAVES or name in COL_BIAS_LEAVES or name in HEAD_LEAVES:
        cls = "col"
    elif name in ROW_LEAVES:
        cls = "row"
    if isinstance(leaf, dict):
        return {k: (cls if k in ("q", "s") else "replicated") for k in leaf}
    return cls


def param_shardings(cfg: ModelConfig, mesh: Mesh, params: dict) -> dict:
    """The placement class of every leaf of ``params`` (a tree of the same
    structure). Under context parallelism everything is replicated."""
    plan = plan_shards(cfg, mesh.tp, params)

    def stack(st):
        return {k: _leaf_class(k, v, plan) for k, v in st.items()}

    out = {}
    for name, sub in params.items():
        if name in ("layers", "moe_layers"):
            out[name] = stack(sub)
        elif name == "hybrid_layers":
            out[name] = tuple(stack(lp) for lp in sub)
        elif name == "lm_head":
            out[name] = _leaf_class(name, sub, plan)
        elif isinstance(sub, dict):
            out[name] = {k: "replicated" for k in sub}
        else:
            out[name] = "replicated"
    return out


def kv_shardings(cfg: ModelConfig, mesh: Mesh, kv: dict) -> dict:
    """The placement class of every arena of ``kv``: the KV heads on the
    trailing axis (``heads``) where they divide the model axis, else
    ``replicated`` (MLA's latent arena always); the scales with their
    heads; a hybrid's linear states on their head axis; under context
    parallelism the page axis (``pages``) of the K / V arenas."""
    tp = mesh.tp
    out = {}
    for k, v in kv.items():
        if cfg.context_parallel and tp > 1:
            out[k] = "pages" if v.dim() == 4 else "replicated"
        elif tp == 1:
            out[k] = "replicated"
        elif k == "s":
            out[k] = "heads" if cfg.num_attention_heads % tp == 0 else "replicated"
        elif cfg.is_mla:
            out[k] = "replicated" if cfg.mla_latent_cache else (
                "heads" if cfg.num_attention_heads % tp == 0 else "replicated")
        else:
            Hk = cfg.num_key_value_heads
            out[k] = "heads" if Hk % tp == 0 and Hk >= tp else "replicated"
    return out


# ---------------------------------------------------------------------------
# slicing
# ---------------------------------------------------------------------------


def take_cols(leaf, ranges: Sequence[Tuple[int, int]], name: str = "leaf"):
    """The columns ``ranges`` of a linear leaf (its N axis), re-fused in
    order; a quantized leaf's scales follow (block scales by 128-blocks,
    which the ranges must respect)."""
    if isinstance(leaf, dict):
        q = leaf["q"]
        N = q.shape[-1]
        kind = _scale_kind(leaf)
        out = {"q": torch.cat([q[..., a:b] for a, b in ranges], dim=-1).contiguous()}
        for k, v in leaf.items():
            if k == "q":
                continue
            if k != "s":
                out[k] = v
            elif kind == "block":
                for a, b in ranges:
                    if a % 128 or (b % 128 and b != N):
                        raise ValueError(f"{name}: columns [{a}, {b}) cut a 128-block of "
                                         "its block-fp8 scales")
                out[k] = torch.cat([v[..., a // 128: -(-b // 128)] for a, b in ranges],
                                   dim=-1).contiguous()
            else:
                out[k] = torch.cat([v[..., a:b] for a, b in ranges], dim=-1).contiguous()
        return out
    return torch.cat([leaf[..., a:b] for a, b in ranges], dim=-1).contiguous()


def take_rows(leaf, a: int, b: int, name: str = "leaf"):
    """The K rows [a, b) of a linear leaf: packed int4 by its groups' packed
    rows, group and block scales by their groups, per-channel scales and
    other entries whole. Raises where [a, b) cuts a group."""
    if not isinstance(leaf, dict):
        return leaf[..., a:b, :].contiguous()
    unit = row_unit(leaf)
    K = _k_of(leaf)
    if a % unit or (b % unit and b != K):
        raise ValueError(f"{name}: rows [{a}, {b}) cut a group of {unit} rows")
    q = leaf["q"]
    packed = q.dtype == torch.uint8
    out = {"q": (q[..., a // 2: b // 2, :] if packed else q[..., a:b, :]).contiguous()}
    kind = _scale_kind(leaf)
    for k, v in leaf.items():
        if k == "q":
            continue
        if k == "s" and kind == "group":
            out[k] = v[..., a // unit: b // unit, :].contiguous()
        elif k == "s" and kind == "block":
            out[k] = v[..., a // 128: -(-b // 128), :].contiguous()
        else:
            out[k] = v
    return out


def _experts(leaf, a: int, b: int):
    """Experts [a, b) of a stacked expert leaf [(L,) X, K, N]: the expert
    axis is the weight's third from the end. A quantized leaf's entries
    were stacked expert by expert as its ``q`` was, so each has the expert
    axis at the same place from the front, whatever its own rank (group
    scales [(L,) X, K/g, N], W8A8's per-channel [(L,) X, N])."""
    if isinstance(leaf, dict):
        ax = leaf["q"].dim() - 3
        return {k: (v.narrow(ax, a, b - a).contiguous() if v.dim() > ax else v)
                for k, v in leaf.items()}
    return leaf[..., a:b, :, :].contiguous()


def _per_head_cols(width: int, n_heads: int, ranges) -> List[Tuple[int, int]]:
    """Column ranges of the heads ``ranges`` in a [n_heads * width] axis."""
    return [(h0 * width, h1 * width) for h0, h1 in ranges]


def _shard_stack(st: dict, cfg: ModelConfig, plan: ShardPlan, r: int) -> dict:
    H, Hk, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qh, kh = plan.q_heads[r], plan.kv_heads[r]
    linear_layer = "w_gate" in st
    attn_on = plan.attn != "replicated"
    out = {}
    for name, leaf in st.items():
        new = leaf
        if attn_on and name in ("wqkv", "bqkv"):
            if linear_layer:  # [q | k | v], H heads each
                parts = [(h0 + i * H, h1 + i * H) for i in range(3) for h0, h1 in (qh,)]
            else:
                parts = [qh, (H + kh[0], H + kh[1]), (H + Hk + kh[0], H + Hk + kh[1])]
            new = take_cols(leaf, _per_head_cols(D, H, parts), name)
        elif attn_on and name in ("w_gate", "out_norm"):
            new = take_cols(leaf, _per_head_cols(D, H, [qh]), name)
        elif attn_on and name == "decay":
            new = leaf[..., qh[0]:qh[1]].contiguous()
        elif attn_on and name in ("wq", "q_b"):
            new = take_cols(leaf, _per_head_cols(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                                                 H, [qh]), name)
        elif attn_on and name == "kv_b":
            new = take_cols(leaf, _per_head_cols(cfg.qk_nope_head_dim + cfg.v_head_dim, H,
                                                 [qh]), name)
        elif attn_on and name == "wo":
            dv = cfg.v_head_dim if cfg.is_mla else D
            new = take_rows(leaf, qh[0] * dv, qh[1] * dv, name)
        elif name in ("wgu", "bgu") and plan.mlp is not None:
            a, b = plan.mlp[r]
            I = _k_of(st["wdown"])
            new = take_cols(leaf, [(a, b), (I + a, I + b)] if cfg.gated_mlp else [(a, b)],
                            name)
        elif name == "wdown" and plan.mlp is not None:
            new = take_rows(leaf, *plan.mlp[r], name)
        elif name in EXPERT_LEAVES and plan.experts is not None:
            new = _experts(leaf, *plan.experts[r])
        elif name == "moe_wgu" and plan.moe is not None:
            a, b = plan.moe[r]
            I = _k_of(st["moe_wdown"])
            new = take_cols(leaf, [(a, b), (I + a, I + b)], name)
        elif name == "moe_wdown" and plan.moe is not None:
            new = take_rows(leaf, *plan.moe[r], name)
        elif name == "shared_wgu" and plan.shared is not None:
            a, b = plan.shared[r]
            I = _k_of(st["shared_wdown"])
            new = take_cols(leaf, [(a, b), (I + a, I + b)], name)
        elif name == "shared_wdown" and plan.shared is not None:
            new = take_rows(leaf, *plan.shared[r], name)
        out[name] = new
    return out


def shard_params(params: dict, cfg: ModelConfig, mesh: Mesh,
                 rank: Optional[int] = None) -> dict:
    """This rank's tensors of ``params`` (``rank``: a model-axis index, by
    default the mesh's own). The embedding, norms, routers and row-parallel
    biases stay whole; under context parallelism everything does."""
    plan = plan_shards(cfg, mesh.tp, params)
    r = mesh.model_index if rank is None else rank
    if plan.mode == "cp" or plan.tp == 1:
        return params
    out = {}
    for name, sub in params.items():
        if name in ("layers", "moe_layers"):
            out[name] = _shard_stack(sub, cfg, plan, r)
        elif name == "hybrid_layers":
            out[name] = [_shard_stack(lp, cfg, plan, r) for lp in sub]
        elif name == "lm_head" and plan.head is not None:
            out[name] = take_cols(sub, [plan.head[r]], name)
        else:
            out[name] = sub
    return out


def cp_pages(num_pages: int, cp: int, rank: int) -> Tuple[int, int]:
    """The global pages [lo, hi) that context-parallel rank ``rank`` owns."""
    if num_pages % cp:
        raise ValueError(f"{num_pages} pages do not split over {cp} ranks")
    per = num_pages // cp
    return rank * per, (rank + 1) * per


def shard_kv(kv: dict, cfg: ModelConfig, mesh: Mesh, rank: Optional[int] = None,
             params: Optional[dict] = None) -> dict:
    """This rank's part of a whole arena ``kv``: its KV heads on the
    trailing axis (and its scales' heads, its linear states' heads), or,
    under context parallelism, its pages behind a local null page 0 (local
    page i + 1 holds global page lo + i)."""
    r = mesh.model_index if rank is None else rank
    tp = mesh.tp
    if tp == 1:
        return kv
    if cfg.context_parallel:
        out = {}
        for k, v in kv.items():
            if v.dim() == 4:
                lo, hi = cp_pages(v.shape[1], tp, r)
                out[k] = torch.cat([torch.zeros_like(v[:, :1]), v[:, lo:hi]], dim=1)
            else:
                out[k] = v
        return out
    plan = plan_shards(cfg, tp, params or {})
    classes = kv_shardings(cfg, mesh, kv)
    (h0, h1), (k0, k1) = plan.q_heads[r], plan.kv_heads[r]
    out = {}
    for k, v in kv.items():
        if k == "s":
            out[k] = v[:, :, h0:h1].contiguous() if plan.attn != "replicated" else v
        elif classes[k] == "replicated" and plan.attn != "kv_dup":
            out[k] = v
        elif k in ("k", "v"):
            D = v.shape[-1] // (cfg.num_attention_heads if cfg.is_mla
                                else cfg.num_key_value_heads)
            out[k] = v[..., k0 * D: k1 * D].contiguous()
        else:  # static [L, Hk] / per-token [L, np, ps, Hk] scales
            out[k] = v[..., k0:k1].contiguous()
    return out
