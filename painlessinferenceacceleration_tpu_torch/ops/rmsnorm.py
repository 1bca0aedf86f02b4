"""RMSNorm with fp32 statistics, plain and grouped, with an optional sigmoid
gate: the wrappers of ``csrc/rmsnorm.cu`` (K15) and their plain versions.

Port of ``rms_norm``, ``rms_group_norm`` and ``rms_group_norm_sigmoid`` of
``painlessinferenceacceleration_tpu/ops/rmsnorm.py``; K15 replaces its
Pallas ``_rmsnorm_kernel`` (which the JAX package calls only from a
benchmark, its model path running the jnp forms). Each of the three
functions launches K15 on a CUDA tensor and takes its plain version on a
CPU tensor; ``rms_norm`` serves the hidden norms, the per-head q/k norms
(the last axis is the normalised row) and MLA's latent norms.

Batch invariance. A served request's tokens must not depend on its
neighbours (lookahead's lossless check compares streams served at other
batch widths), so a row's norm must have the same bits at every row count.
K15 sums each (row, group)'s squares in an order fixed by the group's width
and element type alone (``norm_plan``: how many lanes share the group and
which 16-byte chunks each holds; ``rms_norm_replay`` repeats that order in
fp32 torch ops, bit for bit), so that holds by construction. The plain
versions sum the fp32 squares in fp64 and round to fp32: torch's reduction
picks its tree by the shape, but the fp64 sum of fp32 squares rounds to the
same fp32 value in any order except where the exact sum lies within ~2^-41
of an fp32 rounding boundary. They stay the CPU path and the oracle.

Each of the three wrappers' ``launches`` counts its K15 launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from painlessinferenceacceleration_tpu_torch import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _normed(xf: torch.Tensor, eps: float) -> torch.Tensor:
    """xf [..., w] fp32 times rsqrt(mean(xf^2) + eps), the mean summed in
    fp64 and rounded to fp32."""
    var = ((xf * xf).sum(dim=-1, keepdim=True, dtype=torch.float64)
           / xf.shape[-1]).to(torch.float32)
    return xf * torch.rsqrt(var + eps)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 scaling (fp64-summed variance), cast back to ``x.dtype``."""
    return (_normed(x.to(torch.float32), eps) * weight.to(torch.float32)).to(x.dtype)


def _halving_sum(xf: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis [..., w] -> [..., 1] in a fixed order: zeros
    pad the axis to a power of two, then the upper half is added to the
    lower half until one lane is left. Every step is an elementwise fp32
    add, so a row's sum has the same bits at every row count and on every
    device (torch's CUDA reductions pick their order by the shape)."""
    w = xf.shape[-1]
    p = 1 << max(w - 1, 0).bit_length()
    if p != w:
        xf = torch.nn.functional.pad(xf, (0, p - w))
    while xf.shape[-1] > 1:
        h = xf.shape[-1] // 2
        xf = xf[..., :h] + xf[..., h:]
    return xf


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, cast back to ``x.dtype``: the JAX
    package's ``layer_norm`` (the gpt2 / opt / gptj / bloom / glm families).
    It has no Pallas body there and no kernel here: plain torch on every
    device, its mean and centred variance summed by ``_halving_sum``, so a
    row's bits do not depend on the row count (a tree verify's row equals
    the AR row)."""
    xf = x.to(torch.float32)
    w = xf.shape[-1]
    mean = _halving_sum(xf) / w
    xc = xf - mean
    var = _halving_sum(xc * xc) / w
    xf = xc * torch.rsqrt(var + eps)
    return (xf * weight.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def rms_group_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float,
                         num_groups: int) -> torch.Tensor:
    """The last axis split into ``num_groups`` equal groups, each normalised
    on its own; ``weight`` spans the whole axis."""
    *lead, d = x.shape
    xf = x.to(torch.float32).reshape(*lead, num_groups, d // num_groups)
    xf = _normed(xf, eps).reshape(*lead, d)
    return (xf * weight.to(torch.float32)).to(x.dtype)


def rms_group_norm_sigmoid_plain(x: torch.Tensor, gate: torch.Tensor,
                                 weight: torch.Tensor, eps: float,
                                 num_groups: int) -> torch.Tensor:
    """``rms_group_norm(x) * sigmoid(gate)``, the product in fp32 on the
    normed value rounded to ``x.dtype`` (where the JAX form rounds)."""
    y = rms_group_norm_plain(x, weight, eps, num_groups)
    return (y.to(torch.float32) * torch.sigmoid(gate.to(torch.float32))).to(x.dtype)


MAX_CHUNKS = 8  # 16-byte chunks a lane holds (csrc/rmsnorm.cu kMaxChunks)
MAX_LANES = 512  # lanes a group (csrc/rmsnorm.cu kMaxLanes)
BLOCK_THREADS = 256


@functools.lru_cache(maxsize=64)
def norm_plan(gw: int, elt: int) -> tuple:
    """K15's split of a group of ``gw`` elements of ``elt`` bytes: (lanes,
    chunks a lane, groups a block). The group is cut into 16-byte chunks;
    up to 32 chunks take a lane each (a power of two of lanes: 16 for 128
    bf16 elements, two groups a warp); up to 256 one warp; wider groups as
    many warps as keep a lane at ``MAX_CHUNKS`` chunks or fewer. Lane l holds
    chunks l, l + lanes, ... A function of (gw, elt) alone: it fixes the
    summation order."""
    chunks = -(-gw * elt // 16)
    if chunks <= 32:
        lanes = 1 << (chunks - 1).bit_length()
    else:
        lanes = 32 * -(-chunks // (32 * MAX_CHUNKS))
        if lanes > MAX_LANES:
            raise ValueError(f"rms_norm: groups of {gw} elements are wider than the "
                             f"kernel takes ({MAX_LANES * MAX_CHUNKS * 16 // elt})")
    return lanes, -(-chunks // lanes), max(1, BLOCK_THREADS // lanes)


def rms_norm_replay(x: torch.Tensor, weight: torch.Tensor, eps: float,
                    num_groups: int = 1) -> torch.Tensor:
    """K15's plain and grouped kinds in its own order of operations, in fp32
    torch ops (each rounded to nearest, none fused): each lane of
    ``norm_plan`` sums the squares of its chunks' elements in ascending
    order, the lanes of a warp meet in the xor butterfly (lanes / 2, ..., 1),
    the warps of a wider group add up in warp order; then sum / gw, a
    correctly rounded 1 / sqrt(mean + eps), (x * r) * w, cast to x's type.
    Bit-equal to the kernel; the test oracle for its order."""
    *lead, d = x.shape
    gw = d // num_groups
    elt = x.element_size()
    lanes, n, _ = norm_plan(gw, elt)
    epc = 16 // elt
    xf = x.to(torch.float32).reshape(-1, gw)
    pad = lanes * n * epc - gw
    xp = torch.nn.functional.pad(xf, (0, pad))  # zeros add nothing
    per_lane = xp.reshape(-1, n, lanes, epc).transpose(1, 2).reshape(-1, lanes, n * epc)
    s = torch.zeros(per_lane.shape[:2], dtype=torch.float32)
    for j in range(n * epc):
        v = per_lane[:, :, j]
        s = s + v * v
    wl = min(lanes, 32)
    s = s.reshape(-1, lanes // wl, wl)
    off = wl // 2
    while off:
        s = s + s[:, :, torch.arange(wl) ^ off]
        off //= 2
    tot = s[:, 0, 0]
    for k in range(1, lanes // wl):
        tot = tot + s[:, k, 0]
    mean = tot / torch.tensor(float(gw), dtype=torch.float32)
    # the square root and the reciprocal correctly rounded to fp32 (torch's
    # fp32 sqrt on the CPU need not be): each taken in fp64, whose 53 bits
    # round to the correctly rounded fp32 result
    sq = torch.sqrt((mean + torch.tensor(eps, dtype=torch.float32)).double()).float()
    r = (1.0 / sq.double()).float()
    y = (xf * r[:, None]).reshape(*lead, d) * weight.to(torch.float32)
    return y.to(x.dtype)


def _vec_bytes(elt: int, *addrs: int) -> int:
    """16 (K15 loads and stores 16-byte vectors) where every address and
    stride in ``addrs`` (the weight's pointer among them) divides by 16, else
    ``elt`` (one element at a time)."""
    bits = 0
    for a in addrs:
        bits |= a
    return elt if bits & 15 else 16


class _Static(ctypes.Structure):
    """What a K15 launch fixes for a type, width, grouping and weight
    (``RmsNormStatic`` of ``csrc/rmsnorm.cu``, field for field): built and
    checked once, so a call converts its pointers and row count only."""
    _fields_ = ([(n, ctypes.c_int) for n in ("groups", "gw", "dtype", "w_dtype", "lanes",
                                              "n_chunks", "per_block")]
                + [("eps", ctypes.c_float)])


# (x's type, device and width, the weight's shape, stride, type and device,
# groups, eps) -> (_Static, its address, a group's bytes, x's element bytes)
_STATICS = {}
_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p)


def _static(x, weight, groups, eps) -> tuple:
    dt, wt = _DTYPES.get(x.dtype), _DTYPES.get(weight.dtype)
    if dt is None or wt is None:
        raise TypeError(f"rms_norm takes fp32 / bf16 rows and weights, not "
                        f"{x.dtype} / {weight.dtype}")
    width = x.shape[-1]
    if (width % groups or weight.shape != (width,) or weight.stride(0) != 1
            or weight.device != x.device):
        raise ValueError(f"rows of {width} in {groups} groups on {x.device}, weight "
                         f"{tuple(weight.shape)} on {weight.device}")
    gw, elt = width // groups, x.element_size()
    lanes, n, per_block = norm_plan(gw, elt)
    st = _Static(groups, gw, dt, wt, lanes, n, per_block, eps)
    return st, ctypes.addressof(st), gw * elt, elt


def _launch(x, weight, gate, eps, groups, wrapper):
    width = x.shape[-1]
    key = (x.dtype, x.device, width, weight.shape, weight.stride(), weight.dtype,
           weight.device, groups, eps)
    hit = _STATICS.get(key)
    if hit is None:
        hit = _STATICS[key] = _static(x, weight, groups, eps)
    _, st, group_bytes, elt = hit
    if x.is_contiguous():
        xc, ldx = x, width
    else:
        xc = x.reshape(-1, width)
        if xc.stride(1) != 1:
            xc = xc.contiguous()
        ldx = xc.stride(0)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    gp = 0
    if gate is not None:
        if gate.shape != x.shape or gate.dtype != x.dtype or gate.device != x.device:
            raise ValueError(f"gate {tuple(gate.shape)} {gate.dtype} on {gate.device} does "
                             f"not match x {tuple(x.shape)} {x.dtype}")
        if not gate.is_contiguous():
            gate = gate.contiguous()
        gp = gate.data_ptr()
    rows = out.numel() // width if width else 0
    if rows:
        xp, wp = xc.data_ptr(), weight.data_ptr()
        vec = _vec_bytes(elt, xp, wp, gp, ldx * elt, group_bytes)
        lib, fn = _build.function("rmsnorm", "rms_norm", _ARGS)
        err = fn(st, xp, wp, gp or None, out.data_ptr(), rows, ldx, vec,
                 _build.stream_of(x))
        if err:
            _build.check(lib, err, "rms_norm")
        wrapper.launches += 1
    return out


def _check_cpu(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cpu":
        raise NotImplementedError(f"{what} on {x.device}")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise each row (the last axis) of ``x`` with ``weight`` [w]."""
    if x.is_cuda:
        return _launch(x, weight, None, eps, 1, rms_norm)
    _check_cpu(x, "rms_norm")
    return rms_norm_plain(x, weight, eps)


def rms_group_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   num_groups: int) -> torch.Tensor:
    """Grouped rmsnorm over the last axis split into ``num_groups`` groups
    (the Ring / Bailing-linear RMSGroupNorm)."""
    if x.is_cuda:
        return _launch(x, weight, None, eps, num_groups, rms_group_norm)
    _check_cpu(x, "rms_group_norm")
    return rms_group_norm_plain(x, weight, eps, num_groups)


def rms_group_norm_sigmoid(x: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor,
                           eps: float, num_groups: int) -> torch.Tensor:
    """Gated grouped rmsnorm, ``rms_group_norm(x) * sigmoid(gate)``: the
    output gate of the linear-attention layers."""
    if x.is_cuda:
        return _launch(x, weight, gate, eps, num_groups, rms_group_norm_sigmoid)
    _check_cpu(x, "rms_group_norm_sigmoid")
    return rms_group_norm_sigmoid_plain(x, gate, weight, eps, num_groups)


for _wrapper in (rms_norm, rms_group_norm, rms_group_norm_sigmoid):
    _wrapper.launches = 0
