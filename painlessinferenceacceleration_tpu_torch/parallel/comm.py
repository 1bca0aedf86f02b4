"""The rank state of the parallel forward and its collectives.

A rank of a ``DistLLM`` runs the forward on its own shard of the
parameters (``parallel/mesh.py``). ``DistLLM`` sets the rank's
``RankState`` around its scheduler (``using(state)``, as the JAX package's
``jax.set_mesh`` does for its ``shard_map`` paths). The forward's entry
points (``models/base.py transformer_hidden`` and ``logits_from_hidden``,
``engine/step.py``'s verify) read it once a call (``current()``) and hand
it down to the blocks as their ``par`` argument, which tells each block
which of its products are partial and over which process group they add
up. Each process holds one rank, so the state is the rank's own. With no
state set the forward is the one-process forward.

Every sum over ranks is taken in rank order, in fp32, on every rank:
``gather_ordered`` writes this rank's part into its slot of a zeroed
``[n, ...]`` buffer and runs one ``all_reduce``; adding zeros is exact
(the buffer travels as an integer view, so even a -0.0 keeps its sign),
so the reduce is a gather whatever order the backend sums in, and
``sum_ordered`` then adds the slots in rank order. An ``all_reduce(SUM)``
of the parts themselves would sum in the backend's order (under gloo's
ring, one that depends on the tensor's size), and a verify row would then
not carry the AR row's bits. Under gloo a CUDA tensor takes ``all_reduce``
and ``broadcast`` only, which is all this uses.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Tuple

import torch

from painlessinferenceacceleration_tpu_torch.layers.linear import (
    LinearParams,
    QuantSpec,
    linear,
    linear_at,
)


@dataclasses.dataclass
class RankState:
    """What the forward of one rank needs to know about the others.

    - ``tp`` ranks of the model axis split the heads and the MLP's
      intermediate width (``attn_split`` / ``mlp_split`` say whether this
      model's blocks are split, ``moe_split`` / ``shared_split`` the
      routed and the shared experts' widths; a block that is not split is
      replicated and computed whole), ``head_widths`` the LM head's
      vocabulary columns a rank (None: the head is replicated); under
      ``mode`` "ep" the experts split instead of their widths;
    - ``cp`` ranks of the model axis own the KV pages
      ``[rank * per, (rank + 1) * per)`` instead, with the parameters
      replicated;
    - ``dp`` data groups split the batch's rows in contiguous blocks.
    """

    model_group: object = None
    model_rank: int = 0
    model_size: int = 1
    data_group: object = None
    data_rank: int = 0
    data_size: int = 1
    mode: str = "tp"  # "tp" | "ep" | "cp": what the model axis splits
    attn_split: bool = True
    mlp_split: bool = True
    moe_split: bool = True
    shared_split: bool = True
    head_widths: Optional[Tuple[int, ...]] = None
    # host seconds spent in collectives, and their count
    comm_s: float = 0.0
    comm_n: int = 0

    @property
    def tp(self) -> int:
        return self.model_size if self.mode in ("tp", "ep") else 1

    @property
    def cp(self) -> int:
        return self.model_size if self.mode == "cp" else 1

    @property
    def dp(self) -> int:
        return self.data_size


_CURRENT: Optional[RankState] = None


def current() -> Optional[RankState]:
    """The ambient rank state, or None (the one-process forward)."""
    return _CURRENT


@contextlib.contextmanager
def using(state: Optional[RankState]):
    """Set the ambient rank state for the body."""
    global _CURRENT
    old, _CURRENT = _CURRENT, state
    try:
        yield state
    finally:
        _CURRENT = old


def _int_view(x: torch.Tensor) -> torch.Tensor:
    """x's bytes as a flat integer tensor (int32 where they divide by 4)."""
    b = x.contiguous().reshape(-1).view(torch.uint8)
    return b.view(torch.int32) if b.numel() % 4 == 0 else b


def gather_ordered(x: torch.Tensor, group, rank: int, size: int,
                   state: Optional[RankState] = None) -> torch.Tensor:
    """[size, *x.shape]: every rank's ``x`` (same shape and type on every
    rank) in rank order, bit for bit, through one ``all_reduce`` of a zeroed
    integer buffer in which each rank fills its own slot."""
    if size == 1:
        return x[None]
    import torch.distributed as dist

    t0 = time.perf_counter()
    flat = _int_view(x)
    buf = torch.zeros((size, flat.numel()), dtype=flat.dtype, device=x.device)
    buf[rank] = flat
    dist.all_reduce(buf, group=group)
    out = buf.view(torch.uint8).view(x.dtype).reshape((size,) + tuple(x.shape))
    if state is not None:
        state.comm_s += time.perf_counter() - t0
        state.comm_n += 1
    return out


def sum_ordered(parts: torch.Tensor) -> torch.Tensor:
    """parts [n, ...] added in rank order: ((p0 + p1) + p2) + ..."""
    out = parts[0]
    for i in range(1, parts.shape[0]):
        out = out + parts[i]
    return out


def model_gather(x: torch.Tensor, st: RankState) -> torch.Tensor:
    """Every model-axis rank's ``x``, in rank order."""
    return gather_ordered(x, st.model_group, st.model_rank, st.model_size, st)


def data_gather(x: torch.Tensor, st: RankState) -> torch.Tensor:
    """Every data group's ``x``, in group order."""
    return gather_ordered(x, st.data_group, st.data_rank, st.data_size, st)


def reduce_partial(part: torch.Tensor, st: RankState) -> torch.Tensor:
    """The model axis's fp32 partials of a row-parallel product, added in
    rank order (fp32 in, fp32 out)."""
    return sum_ordered(model_gather(part.to(torch.float32), st))


def quantizes_slices(p: LinearParams, spec: Optional[QuantSpec],
                     par: Optional[RankState]) -> bool:
    """Whether a rank's K-slice of x in ``x @ p`` is quantized with the
    whole rows' amax (``row_amax``): p is a dynamic W8A8 leaf, which
    quantizes x with each row's own amax, and ``par`` splits the rows over
    more than one model rank. Block-fp8 scales are per 128-block (a slice
    holds whole blocks) and weight-only leaves do not quantize x."""
    return (par is not None and par.tp > 1 and isinstance(p, dict) and spec is not None
            and spec.act == "dyn" and not spec.block)


def row_amax(x: torch.Tensor, par: RankState) -> torch.Tensor:
    """The fp32 amax of each whole row of which ``x`` [..., K] holds this
    rank's K-slice, [...]: every model rank's slice amaxes gathered in one
    collective, their max taken (exact)."""
    return model_gather(x.abs().amax(dim=-1).to(torch.float32), par).amax(dim=0)


def _row_part(p: LinearParams, x: torch.Tensor, spec: Optional[QuantSpec],
              par: RankState) -> torch.Tensor:
    """This rank's fp32 partial of a row-parallel ``x @ W`` (x is its
    K-slice). A dynamic W8A8 leaf quantizes the slice with the whole rows'
    per-token scale (``row_amax``), so each rank's int8 / e4m3 activations
    are those one process makes of its columns (the JAX package's global
    amax under GSPMD)."""
    if quantizes_slices(p, spec, par):
        from painlessinferenceacceleration_tpu_torch.ops.w8a8 import w8a8_matmul

        return w8a8_matmul(x, p, spec, torch.float32,
                           row_amax(x.reshape(-1, x.shape[-1]), par))
    return linear(p, x, spec, out_dtype=torch.float32)


def linear_rows(p: LinearParams, x: torch.Tensor, spec: Optional[QuantSpec],
                par: Optional[RankState], split: bool = True) -> torch.Tensor:
    """``x @ W`` for a row-parallel ``W`` (``wo``, ``wdown``): under the
    tensor parallelism of ``par`` this rank's rows of W give an fp32
    partial (``_row_part``), the model ranks' partials are added in rank
    order on every rank, and the sum is rounded once to x's type. With no
    ``par``, one model rank, or ``split`` False (the block is replicated):
    ``linear``."""
    if par is None or par.tp == 1 or not split:
        return linear(p, x, spec)
    return reduce_partial(_row_part(p, x, spec, par), par).to(x.dtype)


def linear_rows_at(p_stacked: LinearParams, li: int, x: torch.Tensor,
                   spec: Optional[QuantSpec], par: Optional[RankState],
                   split: bool = True) -> torch.Tensor:
    """``linear_rows`` over layer ``li`` of stacked leaves."""
    if par is None or par.tp == 1 or not split:
        return linear_at(p_stacked, li, x, spec)
    p = ({k: v[li] for k, v in p_stacked.items()} if isinstance(p_stacked, dict)
         else p_stacked[li])
    return reduce_partial(_row_part(p, x, spec, par), par).to(x.dtype)


def gather_columns(part: torch.Tensor, st: RankState) -> torch.Tensor:
    """A column-parallel output whose last axis is split as
    ``st.head_widths`` says, gathered whole on every rank (uneven widths
    travel padded to the widest)."""
    widths = st.head_widths
    wmax = max(widths)
    if part.shape[-1] != wmax:
        part = torch.nn.functional.pad(part, (0, wmax - part.shape[-1]))
    parts = model_gather(part, st)
    return torch.cat([parts[r, ..., :w] for r, w in enumerate(widths)], dim=-1)


def check_same(x: torch.Tensor, group, rank: int, size: int, what: str) -> None:
    """Raise unless every rank of ``group`` holds ``x`` with the same bits
    (replicated activations and each step's tokens must agree: a
    disagreement is a fault, not something to retry)."""
    if size == 1:
        return
    parts = gather_ordered(x, group, rank, size)
    for r in range(1, size):
        if not torch.equal(_int_view(parts[r]), _int_view(parts[0])):
            raise RuntimeError(f"ranks disagree on {what}: rank {r} differs from rank 0")


def data_block(B: int, st: RankState) -> Tuple[int, int, int, List[int]]:
    """This data group's contiguous block of a batch of ``B`` rows: (first
    row, rows, the largest group's rows, every group's rows in group
    order). The groups split the rows as ``split_sizes`` does."""
    sizes = split_sizes(B, st.dp)
    return sum(sizes[:st.data_rank]), sizes[st.data_rank], max(sizes), sizes


def block_rows(t: Optional[torch.Tensor], a: int, n: int, bmax: int,
               pad: str = "first") -> Optional[torch.Tensor]:
    """Rows [a, a + n) of ``t``, padded to ``bmax`` rows with copies of row 0
    (``pad`` "first") or with zeros ("zeros": padding that writes nothing
    where the rows are validity masks or counts)."""
    if t is None:
        return None
    part = t[a:a + n]
    if n < bmax:
        fill = t[:1].expand(bmax - n, *t.shape[1:])
        if pad == "zeros":
            fill = torch.zeros_like(fill)
        part = torch.cat([part, fill], dim=0)
    return part


def split_sizes(n_units: int, parts: int) -> List[int]:
    """``n_units`` cut into ``parts`` as evenly as they go, the larger parts
    first (86 groups over 4 ranks: 22, 22, 21, 21)."""
    base, extra = divmod(n_units, parts)
    return [base + (1 if r < extra else 0) for r in range(parts)]
