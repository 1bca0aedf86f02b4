"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
where there is none (the CPU test run). Run them on a machine with a card:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

(``--noconftest``: the tests directory's conftest imports JAX, which a
machine for the port need not have.)

Tolerances: bf16 outputs within 2e-2 relative to the plain fp32-accumulated
version (the e4m3 arena modes too: their plain version rounds the
dequantized rows to bf16, the kernel does not); fp32 outputs within 1e-4
(sums in another order); the int8 W8A8 GEMM (exact integer sums), the KV
permute, the page write, the row write and the row move bit for bit. The batch-invariance tests
ask for bit equality: a row's result must not depend on the batch width,
or lookahead serving would not reproduce AR serving. The grouped
(per-expert) GEMMs are held to the same tolerances, their rows past
``n_used`` to exact zeros, and a routed row to the bits of the dense kernel
on that expert's weights.
"""

import numpy as np
import pytest
import torch

from _kv_cases import CASES, compact_case

from painlessinferenceacceleration_tpu_torch.ops.attention import (
    causal_qmask,
    paged_attention_ref,
)
from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
    kv_permute_pages,
    kv_permute_pages_plain,
    kv_write_pages,
    kv_write_pages_plain,
)
from painlessinferenceacceleration_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_prefill,
    paged_attention_tok,
)
from painlessinferenceacceleration_tpu_torch.ops.mla_attention import CHUNK_KEYS
from painlessinferenceacceleration_tpu_torch.ops.rmsnorm import rms_norm
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec
from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import (
    BLOCK_M,
    dense_matmul,
    dense_matmul_plain,
    grouped_matmul,
    grouped_matmul_plain,
    grouped_quant_matmul,
    grouped_quant_matmul_plain,
    moe_align,
    routed_expert_mlp,
    _block_rows,
)
from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
    int4_matmul,
    int4_matmul_plain,
    int8_matmul,
    int8_matmul_plain,
)
from painlessinferenceacceleration_tpu_torch.ops.w8a8 import (
    block_fp8_gemm,
    block_fp8_gemm_plain,
    quant_act,
    w8a8_gemm,
    w8a8_gemm_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.parametrize("M,K,N", [(1, 4096, 4096), (17, 11008, 512), (70, 256, 384),
                                   (64, 4096, 22016),  # the generator's Q = 64
                                   (4096, 4096, 1024),  # 8 x 512 prefill rows
                                   (34, 4096, 28672), (300, 14336, 4096),  # Mixtral experts
                                   (8, 2048, 1536), (136, 768, 2048)])  # Qwen3-30B-A3B's
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [128, 64, 32])
def test_int4_gemm(cuda, M, K, N, out, group):
    x = torch.randn(M, K, generator=cuda, device="cuda").to(torch.bfloat16)
    q = torch.randint(0, 256, (K // 2, N), generator=cuda, device="cuda", dtype=torch.uint8)
    s = (torch.rand(K // group, N, generator=cuda, device="cuda") * 0.01).to(torch.bfloat16)
    before = int4_matmul.launches
    got = int4_matmul(x, q, s, out)
    assert int4_matmul.launches == before + 1
    tol = 2e-2 if out == torch.bfloat16 else 1e-4
    assert _rel(got, int4_matmul_plain(x, q, s, out)) < tol


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [128, 64, 32])
def test_int4_rows_do_not_depend_on_their_place_in_the_tile(cuda, out, group):
    """A row alone equals itself at the edges of the 64-row warpgroup tiles
    and the 128-row blocks of a 4096-row call (the prefix test cannot see a
    dependence on the row's place in its tile)."""
    K = N = 4096
    x = torch.randn(4096, K, generator=cuda, device="cuda").to(torch.bfloat16)
    q = torch.randint(0, 256, (K // 2, N), generator=cuda, device="cuda", dtype=torch.uint8)
    s = (torch.rand(K // group, N, generator=cuda, device="cuda") * 0.01).to(torch.bfloat16)
    full = int4_matmul(x, q, s, out)
    for r in (0, 63, 64, 127, 128, 511, 4095):
        assert torch.equal(int4_matmul(x[r:r + 1], q, s, out), full[r:r + 1]), r
    for m in (64, 65, 512):
        assert torch.equal(int4_matmul(x[:m], q, s, out), full[:m]), m


def test_int4_gemm_raises_on_shapes_it_does_not_take(cuda):
    x = torch.randn(4, 4096, generator=cuda, device="cuda").to(torch.bfloat16)
    q = torch.randint(0, 256, (2048, 4104), generator=cuda, device="cuda", dtype=torch.uint8)
    s = torch.ones(32, 4104, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):  # N % 16 != 0
        int4_matmul(x, q, s)
    q = torch.randint(0, 256, (2048, 512), generator=cuda, device="cuda", dtype=torch.uint8)
    with pytest.raises(ValueError):  # a group of 256
        int4_matmul(x, q, torch.ones(16, 512, dtype=torch.bfloat16, device="cuda"))
    with pytest.raises(ValueError):  # a group of 16
        int4_matmul(x, q, torch.ones(256, 512, dtype=torch.bfloat16, device="cuda"))
    with pytest.raises(TypeError):  # fp32 activations
        int4_matmul(x.float(), q, torch.ones(32, 512, dtype=torch.bfloat16, device="cuda"))


def _arena(g, B, ctx, Q, Hkv, D=128, ps=64):
    P = -(-(max(ctx) + Q) // ps) + 1
    n = B * P + 1
    k = torch.randn(n, ps, Hkv * D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(n, ps, Hkv * D, generator=g, device="cuda").to(torch.bfloat16)
    pt = (torch.randperm(n - 1, generator=g, device="cuda")[: B * P] + 1).reshape(B, P)
    return k, v, pt.to(torch.int32), torch.tensor(ctx, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("Q,Hq,Hkv", [(1, 8, 8), (17, 8, 2), (5, 4, 4)])
def test_paged_attention(cuda, Q, Hq, Hkv):
    k, v, pt, ctx = _arena(cuda, 2, [130, 7], Q, Hkv)
    q = torch.randn(2, Q, Hq, 128, generator=cuda, device="cuda").to(torch.bfloat16)
    qm = (torch.rand(2, Q, Q, generator=cuda, device="cuda") < 0.5) | torch.eye(
        Q, dtype=torch.bool, device="cuda")
    got = paged_attention(q, k, v, pt, ctx, qm, 128 ** -0.5)
    assert _rel(got, paged_attention_ref(q, k, v, pt, ctx, qm, 128 ** -0.5)) < 2e-2


@pytest.mark.parametrize("ctx", [[0, 0], [70, 3]])
def test_paged_attention_prefill(cuda, ctx):
    k, v, pt, ctx_t = _arena(cuda, 2, ctx, 200, 4)
    q = torch.randn(2, 200, 4, 128, generator=cuda, device="cuda").to(torch.bfloat16)
    got = paged_attention_prefill(q, k, v, pt, ctx_t, 128 ** -0.5)
    qm = causal_qmask(200, "cuda")[None].expand(2, 200, 200)
    assert _rel(got, paged_attention_ref(q, k, v, pt, ctx_t, qm, 128 ** -0.5)) < 2e-2


def _on_card(c, dtype, wide=False):
    it = torch.int64 if wide else torch.int32
    k, v = (torch.from_numpy(c[n]).to("cuda").to(dtype) for n in ("k", "v"))
    args = (*(torch.from_numpy(c[n]).to("cuda").to(it) for n in ("pt", "ctx", "path", "ne")),
            c["Q"], torch.from_numpy(c["active"]).to("cuda"))
    return k, v, args


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", CASES)
def test_kv_compact_tail_equals_its_plain_version(cuda, kind, dtype):
    """K4's compaction entry, K and V in one launch, bit-equal to the
    composed route (``tail_window`` + ``kv_permute_pages_plain``) over the
    whole arenas, page 0 included; int64 indices in one case. MLA's case
    has 576- and 512-lane rows."""
    from painlessinferenceacceleration_tpu_torch.ops import kv_update as ku

    c = compact_case(kind, widths=(512, 512) if kind == "mla" else (64, 64))
    k, v, args = _on_card(c, dtype, wide=kind == "r2l8")
    want = ku.kv_compact_tail_plain((k.clone(), v.clone()), *args)
    before = ku.kv_compact_tail.launches
    got = ku.kv_compact_tail((k.clone(), v.clone()), *args)
    assert ku.kv_compact_tail.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("heads", [4, 2])
@pytest.mark.parametrize("kind", CASES)
def test_kv_compact_tail_four_arenas_equal_their_plain_version(cuda, kind, heads):
    """fp8_tok's compaction, e4m3 K and V and f32 scale rows of 4 heads (16
    bytes: bulk copies) or 2 heads (8 bytes: the 4-byte route), in one
    launch of K4's compaction entry, bit-equal to the plain version over the
    whole arenas, page 0 included."""
    from painlessinferenceacceleration_tpu_torch.ops import kv_update as ku

    c = compact_case(kind, widths=(1024, 1024))
    k, v, args = _on_card(c, torch.float32)
    g = torch.Generator(device="cuda").manual_seed(1)
    arenas = (k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn),
              *(torch.rand(*k.shape[:3], heads, generator=g, device="cuda") for _ in range(2)))
    want = ku.kv_compact_tail_plain(tuple(a.clone() for a in arenas), *args)
    before = ku.kv_compact_tail.launches
    got = ku.kv_compact_tail(tuple(a.clone() for a in arenas), *args)
    assert ku.kv_compact_tail.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_compaction_is_one_launch_in_every_arena_kind(cuda):
    """``_commit_and_compact`` in the bf16, static e4m3 and per-token e4m3
    arenas: one K4 launch a verify step, no K6."""
    from types import SimpleNamespace

    from painlessinferenceacceleration_tpu_torch.engine.step import _commit_and_compact
    from painlessinferenceacceleration_tpu_torch.ops import kv_update as ku

    c = compact_case("r2l8", widths=(256, 256))
    k, v, args = _on_card(c, torch.bfloat16)
    pt, ctx, path, ne, Q, active = args
    cfg = SimpleNamespace(linear_attention=False)
    for kvq in ("none", "fp8", "fp8_tok"):
        kv = dict(k=k.clone(), v=v.clone())
        if kvq != "none":
            kv = {n: t.to(torch.float8_e4m3fn) for n, t in kv.items()}
        if kvq == "fp8_tok":
            kv.update(k_tok_scale=torch.rand(*k.shape[:3], 2, device="cuda"),
                      v_tok_scale=torch.rand(*k.shape[:3], 2, device="cuda"))
        want = ku.kv_compact_tail_plain(tuple(t.clone() for t in kv.values()), *args)
        before = (ku.kv_compact_tail.launches, ku.kv_write_pages.launches)
        _commit_and_compact(kv, cfg, pt, ctx, active, None, None, None, path, ne, Q)
        assert (ku.kv_compact_tail.launches, ku.kv_write_pages.launches) == (before[0] + 1,
                                                                               before[1])
        for a, b in zip(kv.values(), want):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("Q,n_moves", [(17, 8), (64, 40), (128, 120)])
def test_kv_compact_tail_at_7b_rows(cuda, Q, n_moves):
    """8192-byte rows, every move of a path of n_moves edges (a random tree
    path: rows shift down, some onto other moves' sources), two requests
    with windows across a page edge, one launch through compact_kv_tail."""
    from painlessinferenceacceleration_tpu_torch.engine.cache import compact_kv_tail
    from painlessinferenceacceleration_tpu_torch.ops import kv_update as ku

    rng = np.random.default_rng(Q)
    L, P, B = 4, 5, 2
    k = torch.randn(L, B * P + 1, 64, 4096, generator=cuda, device="cuda").to(torch.bfloat16)
    v = torch.randn_like(k)
    pt = (torch.randperm(B * P, generator=cuda, device="cuda") + 1).reshape(B, P).int()
    ctx = torch.tensor([60, 130], device="cuda")
    path = torch.zeros(B, Q - 1, dtype=torch.int32, device="cuda")
    for b in range(B):
        path[b, :n_moves] = torch.from_numpy(np.sort(rng.choice(np.arange(1, Q), n_moves,
                                                                replace=False)))
    ne = torch.full((B,), n_moves, dtype=torch.int32, device="cuda")
    k0 = k.clone()
    want = ku.kv_compact_tail_plain((k.clone(), v.clone()), pt, ctx, path, ne, Q)
    before = ku.kv_compact_tail.launches
    got = compact_kv_tail((k, v), pt, ctx, path, ne, Q, torch.ones(B, dtype=torch.bool,
                                                                   device="cuda"))
    assert ku.kv_compact_tail.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], k0)  # rows moved


def test_kv_permute_pages_takes_int64_indices(cuda):
    from painlessinferenceacceleration_tpu_torch.ops import kv_update as ku

    pages = torch.randn(3, 12, 64, 1024, generator=cuda, device="cuda").to(torch.bfloat16)
    ids = torch.tensor([[2, 3], [7, 7]], device="cuda")  # int64; row 1 aliases
    src = torch.stack([torch.randperm(128, generator=cuda, device="cuda") for _ in range(2)])
    got = ku.kv_permute_pages(pages.clone(), ids, src)
    assert torch.equal(got, kv_permute_pages_plain(pages.clone(), ids, src))


@pytest.mark.parametrize("moving", ["all", "half", "none"])
def test_kv_permute_pages(cuda, moving):
    pages = torch.randn(3, 12, 64, 1024, generator=cuda, device="cuda").to(torch.bfloat16)
    ids = torch.tensor([[2, 3], [7, 7]], dtype=torch.int32, device="cuda")  # row 1 aliases
    src = torch.stack([torch.randperm(128, generator=cuda, device="cuda") for _ in range(2)])
    ident = torch.arange(128, device="cuda").expand(2, 128)
    if moving == "half":  # the first slot's rows stay, the second's take any row
        src = torch.cat([ident[:, :64], src[:, 64:]], dim=1)
    elif moving == "none":
        src = ident.clone()
    got = kv_permute_pages(pages.clone(), ids, src.to(torch.int32))
    assert torch.equal(got, kv_permute_pages_plain(pages.clone(), ids, src))


def _fp8(g, shape, Hkv, tok):
    """Unit-normal rows quantized as the arena writes them: scale = amax/448
    per (layer, kv head), or per (token, kv head) with ``tok``, so the
    dequantized keys are ~N(0, 1) and the softmax is not flat."""
    x = torch.randn(*shape, generator=g, device="cuda")
    xh = x.reshape(*shape[:2], Hkv, -1)
    amax = xh.abs().amax(-1) if tok else xh.abs().amax(dim=(0, 1, 3))
    s = (amax / 448.0).clamp(min=1e-8).contiguous()
    q = (xh / (s[..., None] if tok else s[:, None])).clamp(-448.0, 448.0)
    return q.to(torch.float8_e4m3fn).reshape(shape), s


def _fp8_arena(g, B, ctx, Q, Hkv, tok, D=128, ps=64):
    k, _, pt, ctx_t = _arena(g, B, ctx, Q, Hkv, D, ps)
    n = k.shape[0]
    k8, ks = _fp8(g, (n, ps, Hkv * D), Hkv, tok)
    v8, vs = _fp8(g, (n, ps, Hkv * D), Hkv, tok)
    return k8, v8, ks, vs, pt, ctx_t


def _mask(g, B, Q):
    return (torch.rand(B, Q, Q, generator=g, device="cuda") < 0.5) | torch.eye(
        Q, dtype=torch.bool, device="cuda")


@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
@pytest.mark.parametrize("tok", [False, True], ids=["static", "per_token"])
def test_paged_attention_e4m3(cuda, kind, tok):
    Q = {"decode": 1, "verify": 17, "prefill": 200}[kind]
    Hq, Hkv = 8, 4
    k8, v8, ks, vs, pt, ctx = _fp8_arena(cuda, 2, [130, 7], Q, Hkv, tok)
    q = torch.randn(2, Q, Hq, 128, generator=cuda, device="cuda").to(torch.bfloat16)
    qm = causal_qmask(Q, "cuda")[None].expand(2, Q, Q) if kind == "prefill" \
        else _mask(cuda, 2, Q)
    sc = 128 ** -0.5
    if tok:
        wrapper = paged_attention_tok
        got = paged_attention_tok(q, k8, v8, ks, vs, pt, ctx, sc,
                                  None if kind == "prefill" else qm)
    elif kind == "prefill":
        wrapper = paged_attention_prefill
        got = paged_attention_prefill(q, k8, v8, pt, ctx, sc, (ks, vs))
    else:
        wrapper = paged_attention
        got = paged_attention(q, k8, v8, pt, ctx, qm, sc, (ks, vs))
    arena = "fp8_tok" if tok else "fp8"
    assert wrapper.modes[f"{kind},{arena}"] > 0
    ref = paged_attention_ref(q, k8, v8, pt, ctx, qm, sc, ks, vs)
    assert _rel(got, ref) < 2e-2


@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
@pytest.mark.parametrize("arena", ["bf16", "fp8", "fp8_tok"])
def test_attention_at_serving_shapes(cuda, kind, arena):
    """B = 8 with ragged contexts and distinct page tables, as the serving
    engine batches requests; a prefill batch with rows resumed past a
    cached prefix (start > 0) beside fresh ones. A fault in one request's
    indexing shows against the plain version."""
    Q = {"decode": 1, "verify": 17, "prefill": 512}[kind]
    ctx = ([128, 0, 256, 0, 64, 192, 0, 320] if kind == "prefill"
           else [64, 432, 97, 128, 250, 301, 320, 77])
    Hq = Hkv = 8
    if arena == "bf16":
        k, v, pt, ctx_t = _arena(cuda, 8, ctx, Q, Hkv)
        ks = vs = None
    else:
        k, v, ks, vs, pt, ctx_t = _fp8_arena(cuda, 8, ctx, Q, Hkv, arena == "fp8_tok")
    q = torch.randn(8, Q, Hq, 128, generator=cuda, device="cuda").to(torch.bfloat16)
    qm = causal_qmask(Q, "cuda")[None].expand(8, Q, Q) if kind == "prefill" \
        else _mask(cuda, 8, Q)
    sc = 128 ** -0.5
    scales = None if ks is None else (ks, vs)
    if arena == "fp8_tok":
        got = paged_attention_tok(q, k, v, ks, vs, pt, ctx_t, sc,
                                  None if kind == "prefill" else qm)
    elif kind == "prefill":
        got = paged_attention_prefill(q, k, v, pt, ctx_t, sc, scales)
    else:
        got = paged_attention(q, k, v, pt, ctx_t, qm, sc, scales)
    ref = paged_attention_ref(q, k, v, pt, ctx_t, qm, sc, ks, vs)
    assert _rel(got, ref) < 2e-2


@pytest.mark.parametrize("W,row,wide", [(2, 4096, False), (16, 4096, True), (16, 128, False),
                                       (3, 3, False)])
def test_kv_write_pages_bulk_route(cuda, W, row, wide):
    """K6's bulk copies: Llama-2-7B e4m3 pages (256 KB, several chunks a
    page) at W = 2 and 16, fp8_tok's scale pages of 32 heads (8 KB), pages
    of 192 bytes; the null page named twice and one destination aliased,
    int32 or int64 ids as they come."""
    pages = torch.randint(0, 256, (4, 40, 64, row), generator=cuda, device="cuda",
                          dtype=torch.uint8).view(torch.float8_e4m3fn)
    windows = torch.randint(0, 256, (4, W, 64, row), generator=cuda, device="cuda",
                            dtype=torch.uint8).view(torch.float8_e4m3fn)
    ids = torch.randperm(39, generator=cuda, device="cuda")[:W] + 1
    if W > 2:
        ids[0], ids[-1], ids[1] = 0, 0, ids[2]
    ids = ids if wide else ids.to(torch.int32)
    before = kv_write_pages.launches
    got = kv_write_pages(pages.clone(), windows, ids)
    assert kv_write_pages.launches == before + 1
    ref = kv_write_pages_plain(pages.clone(), windows, ids)
    assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.parametrize("offset,row", [(4, 16), (1, 16), (4, 3)])
def test_kv_write_pages_vector_route(cuda, offset, row):
    """Pointers off the 16-byte grid (4-byte words; bytes) and 12-byte pages
    take the vector loop; aliased ids."""
    n = 3 * 12 * 4 * row
    buf = torch.randint(0, 256, (2, n + 16), generator=cuda, device="cuda", dtype=torch.uint8)
    pages = buf[0, offset: offset + n].view(3, 12, 4, row)
    windows = buf[1, offset: offset + 3 * 5 * 4 * row].view(3, 5, 4, row)
    ids = torch.tensor([4, 0, 4, 9, 0], dtype=torch.int32, device="cuda")
    ref = kv_write_pages_plain(pages.clone(), windows, ids)
    assert torch.equal(kv_write_pages(pages, windows, ids), ref)  # in place, off the grid


@pytest.mark.parametrize("dtype,row", [(torch.float8_e4m3fn, 1024), (torch.float32, 8),
                                       (torch.float32, 3)])
def test_kv_write_pages(cuda, dtype, row):
    ps = 64 if row != 3 else 5  # 5 * 3 * 4 bytes: not a 16-byte multiple
    pages = torch.randn(3, 12, ps, row, generator=cuda, device="cuda").to(dtype)
    windows = torch.randn(3, 5, ps, row, generator=cuda, device="cuda").to(dtype)
    ids = torch.tensor([4, 0, 4, 9, 0], dtype=torch.int32, device="cuda")  # aliases
    before = kv_write_pages.launches
    got = kv_write_pages(pages.clone(), windows, ids)
    assert kv_write_pages.launches == before + 1
    ref = kv_write_pages_plain(pages.clone(), windows, ids)
    assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    assert torch.equal(got[:, 4].view(torch.uint8), windows[:, 2].view(torch.uint8))


@pytest.mark.parametrize("arena", ["bf16", "fp8", "fp8_tok"])
def test_attention_rows_do_not_depend_on_the_width(cuda, arena):
    """Row 0 of a 17-wide tree verify (it sees only the committed keys and
    itself) equals a Q = 1 decode of the same token, bit for bit."""
    Hq = Hkv = 8
    if arena == "bf16":
        k, v, pt, ctx = _arena(cuda, 2, [200, 61], 17, Hkv)
        ks = vs = None
    else:
        k, v, ks, vs, pt, ctx = _fp8_arena(cuda, 2, [200, 61], 17, Hkv, arena == "fp8_tok")
    q = torch.randn(2, 17, Hq, 128, generator=cuda, device="cuda").to(torch.bfloat16)
    qm = _mask(cuda, 2, 17)
    qm[:, 0] = False
    qm[:, 0, 0] = True
    one = torch.ones(2, 1, 1, dtype=torch.bool, device="cuda")

    def run(qq, m):
        if arena == "fp8_tok":
            return paged_attention_tok(qq, k, v, ks, vs, pt, ctx, 0.088, m)
        return paged_attention(qq, k, v, pt, ctx, m, 0.088,
                               None if ks is None else (ks, vs))
    assert torch.equal(run(q, qm)[:, :1], run(q[:, :1].contiguous(), one))


def _any_arena(g, B, ctx, Q, Hkv, arena):
    """(k, v, pt, ctx_t, attend) over an arena of the kind: attend(q,
    qmask or None for the causal rule) runs the wrapper that serves it."""
    if arena == "bf16":
        k, v, pt, ctx_t = _arena(g, B, ctx, Q, Hkv)
        ks = vs = None
    else:
        k, v, ks, vs, pt, ctx_t = _fp8_arena(g, B, ctx, Q, Hkv, arena == "fp8_tok")

    def attend(q, qm, c=None, alibi=None, pos=None):
        c = ctx_t if c is None else c
        sc = 128 ** -0.5
        if arena == "fp8_tok":
            return paged_attention_tok(q, k, v, ks, vs, pt, c, sc, qm, alibi, pos)
        scales = None if ks is None else (ks, vs)
        if qm is None:
            return paged_attention_prefill(q, k, v, pt, c, sc, scales, alibi)
        return paged_attention(q, k, v, pt, c, qm, sc, scales, alibi, pos)

    def plain(q, qm, c=None, alibi=None, pos=None):
        c = ctx_t if c is None else c
        return paged_attention_ref(q, k, v, pt, c, qm, 128 ** -0.5, ks, vs, alibi=alibi,
                                   alibi_pos=pos)
    return ctx_t, attend, plain


@pytest.mark.parametrize("arena", ["bf16", "fp8", "fp8_tok"])
@pytest.mark.parametrize("G", [1, 4])
def test_attention_rows_are_the_same_in_every_route(cuda, arena, G):
    """Row t of a causal prefill chunk (Q = 129 and 512, over 0 and 333
    cached keys) equals, bit for bit, a Q = 1 decode of that token over
    ctx + t keys: a token's attention does not depend on the route."""
    Hkv = 8
    Hq = G * Hkv
    one = torch.ones(1, 1, 1, dtype=torch.bool, device="cuda")
    for Q in (129, 512):
        for ctx in (0, 333):
            ctx_t, attend, plain = _any_arena(cuda, 1, [ctx], Q, Hkv, arena)
            q = torch.randn(1, Q, Hq, 128, generator=cuda, device="cuda").to(torch.bfloat16)
            pre = attend(q, None)
            qm = causal_qmask(Q, "cuda")[None]
            assert _rel(pre, plain(q, qm)) < 2e-2
            for t in sorted({0, 1, 31, 32, 63, 64, 127, 128, Q // 2 + 5, Q - 1}):
                row = attend(q[:, t:t + 1].contiguous(), one, ctx_t + t)
                assert torch.equal(row[:, 0], pre[:, t]), (Q, ctx, t)


@pytest.mark.parametrize("arena", ["bf16", "fp8_tok"])
@pytest.mark.parametrize("Q,G", [(63, 1), (64, 1), (65, 1), (127, 1), (128, 1), (129, 1),
                                 (16, 4), (17, 4), (32, 4), (33, 4), (16, 8), (17, 8)])
def test_attention_at_tile_edges(cuda, arena, Q, G):
    """The kernel against its plain version where Q * G sits at a tile edge
    (63 / 64 / 65 rows: one warpgroup's rows, the second all padding;
    127 / 128 / 129: one tile full, or a second tile of one position), at
    contexts off the page grid, by the mask rule (Q <= 128) and the causal
    rule."""
    Hkv = 4
    Hq = G * Hkv
    ctx_t, attend, plain = _any_arena(cuda, 2, [70, 333], Q, Hkv, arena)
    q = torch.randn(2, Q, Hq, 128, generator=cuda, device="cuda").to(torch.bfloat16)
    if Q <= 128:
        qm = _mask(cuda, 2, Q)
        assert _rel(attend(q, qm), plain(q, qm)) < 2e-2
    qm = causal_qmask(Q, "cuda")[None].expand(2, Q, Q)
    assert _rel(attend(q, None), plain(q, qm)) < 2e-2


def test_attention_refuses_what_the_kernel_does_not_take(cuda):
    k, v, pt, ctx = _arena(cuda, 1, [40], 1, 4, ps=16)  # pages of 16 keys
    q = torch.randn(1, 1, 4, 128, generator=cuda, device="cuda").to(torch.bfloat16)
    one = torch.ones(1, 1, 1, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="pages of 64"):
        paged_attention(q, k, v, pt, ctx, one, 0.1)
    k, v, pt, ctx = _arena(cuda, 1, [40], 1, 4, D=112)
    q = torch.randn(1, 1, 4, 112, generator=cuda, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        paged_attention(q, k, v, pt, ctx, one, 0.1)
    k, v, pt, ctx = _arena(cuda, 1, [40], 1, 1)
    q = torch.randn(1, 1, 256, 128, generator=cuda, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="query heads a kv head"):  # G = 256
        paged_attention(q, k, v, pt, ctx, one, 0.1)


def test_gemm_and_norm_rows_do_not_depend_on_the_batch(cuda):
    x = torch.randn(512, 4096, generator=cuda, device="cuda").to(torch.bfloat16)
    q = torch.randint(0, 256, (2048, 4096), generator=cuda, device="cuda", dtype=torch.uint8)
    s = (torch.rand(32, 4096, generator=cuda, device="cuda") * 0.01).to(torch.bfloat16)
    full = int4_matmul(x, q, s)
    w = torch.ones(4096, dtype=torch.bfloat16, device="cuda")
    norm = rms_norm(x, w)
    for m in (1, 2, 8, 17, 136):
        assert torch.equal(int4_matmul(x[:m], q, s), full[:m])
        assert torch.equal(rms_norm(x[:m], w), norm[:m])


# ---------------------------------------------------------------------------
# the 8-bit GEMMs: int8 weight-only, W8A8 per channel (int8 / e4m3), block fp8
# ---------------------------------------------------------------------------

# 7B layer widths, the serving prefill height, and ragged edges: K and N off
# the 128 grid, K odd. The block-fp8 kernel (K8's body) takes K and N in
# multiples of 16 only (TMA's row strides): the last two are its refusals.
GEMM_SHAPES = [(1, 4096, 4096), (17, 11008, 512), (70, 256, 384), (4096, 4096, 1024),
               (9, 200, 132), (17, 333, 260)]
# the block-fp8 kernel's shapes: the first four of GEMM_SHAPES, K and N off
# the 128 grid on the 16 grid (partial K and column blocks), the generator's
# Q = 64 on gate/up and the LM head's width
BLOCK_FP8_SHAPES = GEMM_SHAPES[:4] + [(9, 208, 144), (17, 336, 272), (64, 4096, 22016),
                                      (512, 4096, 32000)]
# the int8 weight-only kernel takes groups that are multiples of 32 and N in
# multiples of 16 (TMA's row strides): (M, K, N, group) over the 7B widths,
# the generator's Q = 64 on gate/up, a Mixtral expert's down projection at
# 300 rows, group 64, a whole-K group (DeepSeek-V2-Lite's dense down
# projection: 10944 rows, stages of 64) at verify width, and off-grid
# shapes whose group is all of K (stages of 32 and 64)
INT8_SHAPES = [(1, 4096, 4096, 128), (17, 11008, 512, 128), (70, 256, 384, 64),
               (4096, 4096, 1024, 128), (64, 4096, 22016, 128), (300, 14336, 4096, 128),
               (17, 10944, 2048, 10944), (9, 352, 272, 352), (17, 192, 144, 192)]
# the W8A8 kernel takes K and N in multiples of 16 (TMA's row strides): its
# off-grid cases are off the 128 grid only, and it adds the generator's Q =
# 64 on gate/up and a Mixtral expert's down projection at 300 rows
W8A8_SHAPES = [(1, 4096, 4096), (17, 11008, 512), (70, 256, 384), (4096, 4096, 1024),
               (9, 208, 144), (17, 336, 272), (64, 4096, 22016), (300, 14336, 4096)]


def _tol(out):
    return 2e-2 if out == torch.bfloat16 else 1e-4


def _int8_operands(g, M, K, N, group):
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    s = (torch.rand(K // group, N, generator=g, device="cuda") * 0.01).to(torch.bfloat16)
    return x, q, s


@pytest.mark.parametrize("M,K,N,group", INT8_SHAPES)
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_int8_gemm(cuda, M, K, N, group, out):
    x, q, s = _int8_operands(cuda, M, K, N, group)
    before = int8_matmul.launches
    got = int8_matmul(x, q, s, out)
    assert int8_matmul.launches == before + 1
    assert _rel(got, int8_matmul_plain(x, q, s, out)) < _tol(out)


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [128, 64])
def test_int8_rows_do_not_depend_on_their_place_in_the_tile(cuda, out, group):
    """A row alone equals itself at the edges of the 64-row warpgroup tiles
    and the 128-row blocks of a 4096-row call, and the first m rows equal
    the call's (the splits launched as blocks at M <= 64, run in one block
    at M = 4096: the same bits)."""
    x, q, s = _int8_operands(cuda, 4096, 4096, 4096, group)
    full = int8_matmul(x, q, s, out)
    for r in (0, 63, 64, 127, 128, 511, 4095):
        assert torch.equal(int8_matmul(x[r:r + 1], q, s, out), full[r:r + 1]), r
    for m in (1, 17, 64, 65, 136, 512):
        assert torch.equal(int8_matmul(x[:m], q, s, out), full[:m]), m


def test_int8_gemm_raises_on_shapes_it_does_not_take(cuda):
    for K, N, group in ((333, 256, 333), (4096, 260, 128), (4096, 4096, 48), (4096, 4096, 16)):
        x, q, s = _int8_operands(cuda, 4, K, N, group)
        before = int8_matmul.launches
        with pytest.raises(ValueError):
            int8_matmul(x, q, s)
        assert int8_matmul.launches == before
    x, q, s = _int8_operands(cuda, 4, 256, 256, 128)
    with pytest.raises(TypeError):  # fp32 activations
        int8_matmul(x.float(), q, s)


def _w8a8_operands(g, M, K, N, mode):
    """Activations quantized by quant_act from unit-normal rows, and a
    random weight of the mode's format with scales around 0.02/qmax."""
    spec = QuantSpec.from_mode(mode)
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    xq, xs = quant_act(x, spec)
    if spec.wfmt == "fp8":
        q = torch.randn(K, N, generator=g, device="cuda").to(torch.float8_e4m3fn)
    else:
        q = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    shape = (-(-K // 128), -(-N // 128)) if spec.block else (N,)
    s = torch.rand(shape, generator=g, device="cuda") * 1e-4 + 1e-5
    return xq, xs, q, s


@pytest.mark.parametrize("M,K,N", W8A8_SHAPES)
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_w8a8_gemm_int8_is_exact(cuda, M, K, N, out):
    xq, xs, q, s = _w8a8_operands(cuda, M, K, N, "w8a8_int8")
    before = w8a8_gemm.modes["int8"]
    got = w8a8_gemm(xq, xs, q, s, out)
    assert w8a8_gemm.modes["int8"] == before + 1
    assert torch.equal(got, w8a8_gemm_plain(xq, xs, q, s, out))


@pytest.mark.parametrize("M,K,N", W8A8_SHAPES)
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_w8a8_gemm_fp8(cuda, M, K, N, out):
    xq, xs, q, s = _w8a8_operands(cuda, M, K, N, "w8a8_fp8")
    before = w8a8_gemm.modes["fp8"]
    got = w8a8_gemm(xq, xs, q, s, out)
    assert w8a8_gemm.modes["fp8"] == before + 1
    assert _rel(got, w8a8_gemm_plain(xq, xs, q, s, out)) < _tol(out)


@pytest.mark.parametrize("mode", ["w8a8_int8", "w8a8_fp8"])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_w8a8_rows_do_not_depend_on_their_place_in_the_tile(cuda, mode, out):
    """A row alone equals itself at the edges of the 64-row warpgroup tiles
    and the 128-row blocks of a 4096-row call, and the first m rows equal
    the call's (the splits launched as blocks at M <= 64, run in one block
    at M = 4096: the same bits)."""
    xq, xs, q, s = _w8a8_operands(cuda, 4096, 4096, 4096, mode)
    full = w8a8_gemm(xq, xs, q, s, out)
    for r in (0, 63, 64, 127, 128, 511, 4095):
        assert torch.equal(w8a8_gemm(xq[r:r + 1], xs[r:r + 1], q, s, out), full[r:r + 1]), r
    for m in (64, 65, 512):
        assert torch.equal(w8a8_gemm(xq[:m], xs[:m], q, s, out), full[:m]), m


@pytest.mark.parametrize("mode", ["w8a8_int8", "w8a8_fp8"])
def test_w8a8_gemm_raises_off_the_16_grid(cuda, mode):
    for K, N in ((333, 256), (336, 260), (200, 132)):
        xq, xs, q, s = _w8a8_operands(cuda, 17, K, N, mode)
        before = w8a8_gemm.launches
        with pytest.raises(ValueError, match="16"):
            w8a8_gemm(xq, xs, q, s)
        assert w8a8_gemm.launches == before


@pytest.mark.parametrize("M,K,N", BLOCK_FP8_SHAPES)
@pytest.mark.parametrize("mode", ["fp8_block", "fp8_tb"])
def test_block_fp8_gemm(cuda, M, K, N, mode):
    xq, xs, q, s = _w8a8_operands(cuda, M, K, N, mode)
    for out in (torch.bfloat16, torch.float32):
        before = block_fp8_gemm.launches
        got = block_fp8_gemm(xq, xs, q, s, out)
        assert block_fp8_gemm.launches == before + 1
        assert _rel(got, block_fp8_gemm_plain(xq, xs, q, s, out)) < _tol(out)


@pytest.mark.parametrize("M,K,N", [c for c in GEMM_SHAPES if c[1] % 16 or c[2] % 16]
                         + [(17, 336, 260)])
def test_block_fp8_gemm_raises_off_the_16_grid(cuda, M, K, N):
    xq, xs, q, s = _w8a8_operands(cuda, M, K, N, "fp8_block")
    before = block_fp8_gemm.launches
    with pytest.raises(ValueError, match="16"):
        block_fp8_gemm(xq, xs, q, s)
    assert block_fp8_gemm.launches == before


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_block_fp8_rows_do_not_depend_on_their_place_in_the_tile(cuda, out):
    """As K8's: a row alone equals itself at the tile edges of a 4096-row
    call (its splits launched as blocks alone, run in one block at 4096)."""
    xq, xs, q, s = _w8a8_operands(cuda, 4096, 4096, 4096, "fp8_block")
    full = block_fp8_gemm(xq, xs, q, s, out)
    for r in (0, 63, 64, 127, 128, 511, 4095):
        assert torch.equal(block_fp8_gemm(xq[r:r + 1], xs[r:r + 1], q, s, out),
                           full[r:r + 1]), r
    for m in (64, 65, 512):
        assert torch.equal(block_fp8_gemm(xq[:m], xs[:m], q, s, out), full[:m]), m


@pytest.mark.parametrize("K,N", [(4096, 4096), (11008, 4096), (4096, 512), (333, 260),
                                 (336, 272), (352, 272)])
def test_8bit_gemm_rows_do_not_depend_on_the_batch(cuda, K, N):
    """A row of every 8-bit GEMM is the same at M = 1, 8, 17, 136 and 4096,
    bit for bit: AR decode batches B rows, lookahead 17 B, prefill 512 B.
    The int8 weight-only kernel joins where the group (128, or all of K) is
    a multiple of 32 and N of 16, the W8A8 and block-fp8 kernels where K
    and N are multiples of 16 (the shapes each takes)."""
    M = 4096
    x = torch.randn(M, K, generator=cuda, device="cuda").to(torch.bfloat16)
    group = 128 if K % 128 == 0 else K
    runs = {}
    if group % 32 == 0 and N % 16 == 0:
        _, q8, s8 = _int8_operands(cuda, 1, K, N, group)
        runs["int8_gemm"] = lambda m: int8_matmul(x[:m], q8, s8)
    for mode in ("w8a8_int8", "w8a8_fp8", "fp8_block"):
        if K % 16 or N % 16:
            continue
        xq, xs, q, s = _w8a8_operands(cuda, M, K, N, mode)
        fn = block_fp8_gemm if mode == "fp8_block" else w8a8_gemm
        runs[mode] = (lambda m, fn=fn, xq=xq, xs=xs, q=q, s=s:
                      fn(xq[:m], xs[:m], q, s, torch.bfloat16))
    for name, run in runs.items():
        full = run(M)
        for m in (1, 8, 17, 136):
            assert torch.equal(run(m), full[:m]), (name, m)


def test_quant_act_rows_do_not_depend_on_the_batch(cuda):
    x = torch.randn(136, 4096, generator=cuda, device="cuda").to(torch.bfloat16)
    for mode in ("w8a8_int8", "w8a8_fp8", "fp8_block", "fp8_tb"):
        spec = QuantSpec.from_mode(mode)
        xq, xs = quant_act(x, spec)
        for m in (1, 8, 17):
            xq_m, xs_m = quant_act(x[:m], spec)
            assert torch.equal(xq_m.view(torch.uint8), xq[:m].view(torch.uint8)), mode
            assert torch.equal(xs_m, xs[:m]), mode


# ---------------------------------------------------------------------------
# the grouped (per-expert) GEMMs and the dense bf16 GEMM
# ---------------------------------------------------------------------------


# the bf16 kernels take K and N in multiples of 8 (TMA's 16-byte rows): the
# ragged case is off the 64 / 128 grids only
@pytest.mark.parametrize("M,K,N", [(1, 4096, 4096), (17, 4096, 8), (70, 328, 264),
                                   (512, 1024, 128)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("transposed", [False, True])
def test_dense_bf16_gemm(cuda, M, K, N, out, transposed):
    x = torch.randn(M, K, generator=cuda, device="cuda").to(torch.bfloat16)
    w = (torch.randn(K, N, generator=cuda, device="cuda") * 0.05).to(torch.bfloat16)
    wk = w.t().contiguous() if transposed else w
    before = dense_matmul.launches
    got = dense_matmul(x, wk, out, transposed)
    assert dense_matmul.launches == before + 1
    tol = 2e-2 if out == torch.bfloat16 else 1e-4
    assert _rel(got, dense_matmul_plain(x, wk, out, transposed)) < tol
    # the transposed read sums in the same order
    assert torch.equal(got, dense_matmul(x, w, out))


# (K, N, out) of the card's bf16 products: a 7B-width wqkv, Mixtral's
# router, DeepSeek-V2-Lite's kv_a and router, the LM head in fp32
BF16_MODEL_SHAPES = [(4096, 6144, torch.bfloat16), (4096, 8, torch.float32),
                     (2048, 576, torch.bfloat16), (2048, 64, torch.float32),
                     (4096, 32000, torch.float32)]


@pytest.mark.parametrize("K,N,out", BF16_MODEL_SHAPES)
def test_bf16_gemm_at_model_widths(cuda, K, N, out):
    """Decode, verify and prefill widths against the plain version; the
    transposed read (a tied head) gives the plain read's bits."""
    x = torch.randn(512, K, generator=cuda, device="cuda").to(torch.bfloat16)
    w = (torch.randn(K, N, generator=cuda, device="cuda") * 0.02).to(torch.bfloat16)
    wt = w.t().contiguous()
    for M in (1, 17, 512):
        got = dense_matmul(x[:M], w, out)
        assert _rel(got, dense_matmul_plain(x[:M], w, out)) < _tol(out)
        assert torch.equal(dense_matmul(x[:M], wt, out, transposed=True), got)


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("transposed", [False, True])
def test_bf16_rows_do_not_depend_on_their_place_in_the_tile(cuda, out, transposed):
    """A row alone equals itself at the edges of the 64-row warpgroup tiles
    and the 128-row blocks of a 4096-row call, and every prefix of that
    call equals its rows (K = 4096 runs in 5 K splits at M = 1, launched as
    blocks, and in one block per tile at M = 4096: the same bits)."""
    K, N = 4096, 6144
    x = torch.randn(4096, K, generator=cuda, device="cuda").to(torch.bfloat16)
    w = (torch.randn(K, N, generator=cuda, device="cuda") * 0.02).to(torch.bfloat16)
    if transposed:
        w = w.t().contiguous()
    full = dense_matmul(x, w, out, transposed)
    for r in (0, 63, 64, 127, 128, 511, 4095):
        assert torch.equal(dense_matmul(x[r:r + 1], w, out, transposed), full[r:r + 1]), r
    for m in (1, 8, 17, 64, 65, 136, 512):
        assert torch.equal(dense_matmul(x[:m], w, out, transposed), full[:m]), m


def test_bf16_gemm_raises_on_shapes_it_does_not_take(cuda):
    from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import dense_matmul_batched

    def raises(exc, fn, *args, **kw):
        counts = (dense_matmul.launches, dense_matmul_batched.launches,
                  grouped_matmul.launches)
        with pytest.raises(exc):
            fn(*args, **kw)
        assert counts == (dense_matmul.launches, dense_matmul_batched.launches,
                          grouped_matmul.launches)

    def bf16(*shape):
        return torch.randn(*shape, generator=cuda, device="cuda").to(torch.bfloat16)

    raises(ValueError, dense_matmul, bf16(4, 4100), bf16(4100, 256))  # K % 8
    raises(ValueError, dense_matmul, bf16(4, 4096), bf16(4096, 260))  # N % 8
    raises(ValueError, dense_matmul, bf16(4, 4100), bf16(256, 4100), transposed=True)
    raises(ValueError, dense_matmul, bf16(4, 4096), bf16(4097 * 256)[1:4096 * 256 + 1].view(4096, 256))
    raises(TypeError, dense_matmul, bf16(4, 256).float(), bf16(256, 256).float())
    raises(TypeError, dense_matmul, bf16(4, 256), bf16(256, 256), torch.float16)
    raises(ValueError, dense_matmul_batched, bf16(16, 4, 132), bf16(16, 132, 512))
    raises(ValueError, dense_matmul_batched, bf16(16, 4, 128), bf16(16, 128, 500))
    x, topi, xg, dest_tok, be, nu = _grouped_x(cuda, 17, 2, 8, 512, 0.0)
    raises(ValueError, grouped_matmul, xg, be, nu, bf16(8, 512, 1020), n_pairs=17 * 2)


def test_batched_bf16_gemm_splits_long_k_in_one_block(cuda):
    """Past K = 512 a head's K splits run in order in its block: the bits of
    the dense entry, which launches them as blocks at small M."""
    from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import (
        bf16_batched_plan,
        dense_matmul_batched,
        dense_matmul_batched_plain,
    )

    K, N = 2048, 128
    assert bf16_batched_plan(4, 17, K, N).ksplit > 1
    x = torch.randn(4, 300, K, generator=cuda, device="cuda").to(torch.bfloat16)
    w = (torch.randn(4, K, N, generator=cuda, device="cuda") * 0.02).to(torch.bfloat16)
    full = dense_matmul_batched(x, w)
    assert _rel(full, dense_matmul_batched_plain(x, w)) < 2e-2
    for m in (1, 17):
        assert torch.equal(dense_matmul_batched(x[:, :m].contiguous(), w), full[:, :m])
        assert torch.equal(dense_matmul(x[2, :m].contiguous(), w[2]), full[2, :m])


def _routed(g, T, k, X, drop=0.0):
    """A seeded random routing: k distinct experts per token, a share of
    the pairs carrying the dropped-expert sentinel X."""
    topi = torch.rand(T, X, generator=g, device="cuda").argsort(dim=1)[:, :k]
    if drop:
        topi = torch.where(torch.rand(T, k, generator=g, device="cuda") < drop,
                           torch.full_like(topi, X), topi)
    topv = torch.rand(T, k, generator=g, device="cuda")
    return topi.to(torch.int32), topv


def _grouped_x(g, T, k, X, K, drop):
    topi, topv = _routed(g, T, k, X, drop)
    dest_tok, row_w, be, nu = moe_align(topi, topv, X, T)
    x = torch.randn(T, K, generator=g, device="cuda").to(torch.bfloat16)
    xg = torch.cat([x, torch.zeros(1, K, dtype=x.dtype, device="cuda")])[dest_tok.long()]
    return x, topi, xg, dest_tok, be, nu


def _quant_experts(g, X, K, N, bits, group):
    if bits == 4:
        q = torch.randint(0, 256, (X, K // 2, N), generator=g, device="cuda", dtype=torch.uint8)
        s = torch.rand(X, K // group, N, generator=g, device="cuda") * 0.004 + 0.001
    else:
        q = torch.randint(-127, 128, (X, K, N), generator=g, device="cuda", dtype=torch.int8)
        s = torch.rand(X, K // group, N, generator=g, device="cuda") * 2e-4 + 5e-5
    return {"q": q, "s": s.to(torch.bfloat16)}


GROUPED_SHAPES = [(1, 2, 8, 512, 1024), (17, 2, 8, 4096, 512), (300, 8, 128, 768, 256),
                  (600, 2, 8, 328, 264)]  # (T, k, X, K, N); the last is ragged


@pytest.mark.parametrize("T,k,X,K,N", GROUPED_SHAPES)
@pytest.mark.parametrize("use_rows", [False, True])
def test_grouped_gemm(cuda, T, k, X, K, N, use_rows):
    x, topi, xg, dest_tok, be, nu = _grouped_x(cuda, T, k, X, K, 0.25)
    w = (torch.randn(X, K, N, generator=cuda, device="cuda") * 0.05).to(torch.bfloat16)
    rows = _block_rows(dest_tok, T) if use_rows else None
    before = grouped_matmul.launches
    got = grouped_matmul(xg, be, nu, w, rows, n_pairs=T * k)
    assert grouped_matmul.launches == before + 1
    ref = grouped_matmul_plain(xg, be, nu, w)
    assert _rel(got, ref) < 2e-2
    assert not got[int(nu[0]) * BLOCK_M:].any()  # exact zeros past n_used
    # every routed row equals the dense kernel on its expert's weights
    full = torch.stack([dense_matmul(x, w[e]) for e in range(X)])  # [X, T, N]
    real = (dest_tok < T) & (torch.arange(dest_tok.numel(), device="cuda")
                             < nu[0] * BLOCK_M)
    r = real.nonzero()[:, 0]
    e = be[r // BLOCK_M].long()
    assert torch.equal(got[r], full[e, dest_tok[r].long()])


@pytest.mark.parametrize("T,k,X,K,N", [s for s in GROUPED_SHAPES if s[3] % 128 == 0])
@pytest.mark.parametrize("bits,group", [(4, 128), (4, 64), (4, 32), (8, 128), (8, 64)])
def test_grouped_quant_gemm(cuda, T, k, X, K, N, bits, group):
    x, topi, xg, dest_tok, be, nu = _grouped_x(cuda, T, k, X, K, 0.25)
    p = _quant_experts(cuda, X, K, N, bits, group)
    before = grouped_quant_matmul.modes[f"int{bits}"]
    got = grouped_quant_matmul(xg, be, nu, p, bits, _block_rows(dest_tok, T), n_pairs=T * k)
    assert grouped_quant_matmul.modes[f"int{bits}"] == before + 1
    assert _rel(got, grouped_quant_matmul_plain(xg, be, nu, p, bits)) < 2e-2
    assert not got[int(nu[0]) * BLOCK_M:].any()
    # without the row counts
    assert torch.equal(got, grouped_quant_matmul(xg, be, nu, p, bits, n_pairs=T * k))
    dense = int4_matmul if bits == 4 else int8_matmul
    full = torch.stack([dense(x, p["q"][e], p["s"][e]) for e in range(X)])
    real = (dest_tok < T) & (torch.arange(dest_tok.numel(), device="cuda")
                             < nu[0] * BLOCK_M)
    r = real.nonzero()[:, 0]
    e = be[r // BLOCK_M].long()
    assert torch.equal(got[r], full[e, dest_tok[r].long()])


def _check_bounded_grid(g, T, k, X, K, N, bits):
    """The grouped int4 / int8 kernel at decode: the grid bounded to the
    row blocks the routing can use, exact zeros past them (rows there are
    never read), the plain version's values and the dense kernel's bits on
    each routed row."""
    from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import (
        grouped_int4_plan,
        grouped_int8_plan,
    )

    x, topi, xg, dest_tok, be, nu = _grouped_x(g, T, k, X, K, 0.0)
    p = _quant_experts(g, X, K, N, bits, 128)
    rows = _block_rows(dest_tok, T)
    plan_of = grouped_int4_plan if bits == 4 else grouped_int8_plan
    plan = plan_of(xg.shape[0], K, N, 128, X, T * k)
    bound = min(X, T * k) + 1
    assert plan.grid[1] == bound < be.numel()
    assert int(nu[0]) <= bound
    before = grouped_quant_matmul.modes[f"int{bits}"]
    xg_dirty = xg.clone()
    xg_dirty[int(nu[0]) * BLOCK_M:] = 1.0  # rows past n_used and the bound are never read
    got = grouped_quant_matmul(xg_dirty, be, nu, p, bits, rows, n_pairs=T * k)
    assert grouped_quant_matmul.modes[f"int{bits}"] == before + 1
    assert not got[int(nu[0]) * BLOCK_M:].any()  # exact zeros past n_used and the bound
    assert _rel(got, grouped_quant_matmul_plain(xg, be, nu, p, bits)) < 2e-2
    dense = int4_matmul if bits == 4 else int8_matmul
    full = torch.stack([dense(x, p["q"][e], p["s"][e]) for e in range(X)])
    real = (dest_tok < T) & (torch.arange(dest_tok.numel(), device="cuda")
                             < nu[0] * BLOCK_M)
    r = real.nonzero()[:, 0]
    assert r.numel() == T * k
    e = be[r // BLOCK_M].long()
    assert torch.equal(got[r], full[e, dest_tok[r].long()])


DECODE_ROUTINGS = [(1, 2, 8, 4096, 28672),  # Mixtral decode
                   (1, 8, 128, 2048, 1536)]  # Qwen3-30B-A3B decode


@pytest.mark.parametrize("T,k,X,K,N", DECODE_ROUTINGS)
def test_grouped_gemm_at_decode_launches_the_bounded_grid(cuda, T, k, X, K, N):
    """The grouped bf16 kernel at decode: the grid bounded to the row blocks
    the routing can use, exact zeros past them (rows there are never read),
    the plain version's values and the dense entry's bits on each routed
    row."""
    from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import grouped_bf16_plan

    x, topi, xg, dest_tok, be, nu = _grouped_x(cuda, T, k, X, K, 0.0)
    w = (torch.randn(X, K, N, generator=cuda, device="cuda") * 0.02).to(torch.bfloat16)
    plan = grouped_bf16_plan(xg.shape[0], K, N, X, T * k)
    bound = min(X, T * k) + 1
    assert plan.grid[1] == bound < be.numel()
    assert int(nu[0]) <= bound
    before = grouped_matmul.launches
    xg_dirty = xg.clone()
    xg_dirty[int(nu[0]) * BLOCK_M:] = 1.0  # rows past n_used and the bound are never read
    got = grouped_matmul(xg_dirty, be, nu, w, _block_rows(dest_tok, T), n_pairs=T * k)
    assert grouped_matmul.launches == before + 1
    assert not got[int(nu[0]) * BLOCK_M:].any()  # exact zeros past n_used and the bound
    assert _rel(got, grouped_matmul_plain(xg, be, nu, w)) < 2e-2
    # the bits of a launch over every block (a pair count that bounds nothing)
    assert torch.equal(got, grouped_matmul(xg, be, nu, w, n_pairs=xg.shape[0]))
    real = (dest_tok < T) & (torch.arange(dest_tok.numel(), device="cuda")
                             < nu[0] * BLOCK_M)
    r = real.nonzero()[:, 0]
    assert r.numel() == T * k
    e = be[r // BLOCK_M].long()
    for i in range(r.numel()):
        dense = dense_matmul(x[dest_tok[r[i]].long()][None], w[e[i]])
        assert torch.equal(got[r[i]][None], dense)


@pytest.mark.parametrize("T,k,X,K,N", DECODE_ROUTINGS)
def test_grouped_int4_gemm_at_decode_launches_the_bounded_grid(cuda, T, k, X, K, N):
    _check_bounded_grid(cuda, T, k, X, K, N, 4)


@pytest.mark.parametrize("T,k,X,K,N", DECODE_ROUTINGS)
def test_grouped_int8_gemm_at_decode_launches_the_bounded_grid(cuda, T, k, X, K, N):
    _check_bounded_grid(cuda, T, k, X, K, N, 8)


@pytest.mark.parametrize("quant", [None, 4, 8])
def test_routed_mlp_rows_do_not_depend_on_the_batch(cuda, quant):
    """The routed expert MLP of one token, alone and among 599 others."""
    T, k, X, E, I = 600, 2, 8, 512, 256
    x = torch.randn(T, E, generator=cuda, device="cuda").to(torch.bfloat16)
    topi, topv = _routed(cuda, T, k, X, 0.2)
    if quant:
        wgu = _quant_experts(cuda, X, E, 2 * I, quant, 128)
        wdn = _quant_experts(cuda, X, I, E, quant, 128)
    else:
        wgu = (torch.randn(X, E, 2 * I, generator=cuda, device="cuda") * 0.05).to(torch.bfloat16)
        wdn = (torch.randn(X, I, E, generator=cuda, device="cuda") * 0.05).to(torch.bfloat16)
    spec = QuantSpec(bits=quant) if quant else None
    full = routed_expert_mlp(x, topi, topv, wgu, wdn, X, I, spec)
    for m in (1, 8, 17, 136):
        part = routed_expert_mlp(x[:m], topi[:m], topv[:m], wgu, wdn, X, I, spec)
        assert torch.equal(part, full[:m]), m
    again = routed_expert_mlp(x, topi, topv, wgu, wdn, X, I, spec)
    assert torch.equal(again, full)  # the combine has one order on every run


def test_moe_block_routes_agree_bit_for_bit(cuda):
    """Scan, grouped and expert-shard routes of one bf16 MoE layer."""
    import dataclasses

    from painlessinferenceacceleration_tpu_torch.config import ModelConfig
    from painlessinferenceacceleration_tpu_torch.models import moe

    cfg = ModelConfig(model_type="mixtral", hidden_size=512, intermediate_size=256,
                      num_attention_heads=4, num_key_value_heads=4, num_experts=8,
                      num_experts_per_tok=2)
    lp = moe.init_moe_layer(cfg, cuda, torch.bfloat16, None)
    h = torch.randn(1, 1100, 512, generator=cuda, device="cuda").to(torch.bfloat16)
    x = h.reshape(-1, 512)
    rw = moe.route_topk(cfg, moe.router_logits(lp, x))
    for m in (1, 17):  # the router's bits do not depend on the row count
        assert torch.equal(moe.route_topk(cfg, moe.router_logits(lp, x[:m])), rw[:m])
    scan = torch.zeros(x.shape, dtype=torch.float32, device="cuda")
    for e in range(8):
        out = moe._expert_mlp(lp["moe_wgu"][e], lp["moe_wdown"][e], x, None)
        scan = scan + out.float() * rw[:, e][:, None]
    before = grouped_matmul.launches
    got = moe.moe_block(lp, cfg, None, h)  # 1100 * 2 >= 2 * 128 * 8: the grouped route
    assert grouped_matmul.launches == before + 2
    assert torch.equal(got[0], scan.to(torch.bfloat16))
    assert torch.equal(moe.moe_block(lp, cfg, None, h[:, :17]), got[:, :17])  # the scan route
    with moe.expert_shards(2):
        ep = moe.moe_block(lp, dataclasses.replace(cfg, expert_parallel=True), None, h)
    assert torch.equal(ep, got)


def test_native_linears_and_the_tied_head_run_on_the_card(cuda):
    from painlessinferenceacceleration_tpu_torch.layers.embedding import embed_logits
    from painlessinferenceacceleration_tpu_torch.layers.linear import linear, linear_at

    x = torch.randn(2, 17, 256, generator=cuda, device="cuda").to(torch.bfloat16)
    w = (torch.randn(3, 256, 384, generator=cuda, device="cuda") * 0.05).to(torch.bfloat16)
    emb = (torch.randn(1000, 256, generator=cuda, device="cuda") * 0.05).to(torch.bfloat16)
    before = dense_matmul.launches
    got = linear_at(w, 1, x)
    assert got.shape == (2, 17, 384) and got.dtype == torch.bfloat16
    assert _rel(got, dense_matmul_plain(x, w[1])) < 2e-2
    assert torch.equal(linear(w[1], x[:, :1].contiguous()), got[:, :1])
    logits = embed_logits(emb, x)
    assert logits.dtype == torch.float32 and logits.shape == (2, 17, 1000)
    assert _rel(logits, dense_matmul_plain(x, emb, torch.float32, True)) < 1e-4
    assert dense_matmul.launches == before + 3
    with pytest.raises(TypeError):
        linear(w[1].float(), x.float())  # the card's native linears are bf16


# ---------------------------------------------------------------------------
# Multi-head Latent Attention: K13 and the absorption products
# ---------------------------------------------------------------------------

MLA_DK, MLA_DV = 576, 512  # DeepSeek's latent row: kv_lora_rank + rope, kv_lora_rank
C = CHUNK_KEYS  # K13's context chunk: every route folds the same absolute chunks


def _mla_arena(g, B, ctx, Q, ps=64):
    P = -(-(max(ctx) + Q) // ps) + 1
    n = B * P + 1
    k = torch.randn(n, ps, MLA_DK, generator=g, device="cuda").to(torch.bfloat16)
    pt = (torch.randperm(n - 1, generator=g, device="cuda")[: B * P] + 1).reshape(B, P)
    return k, pt.to(torch.int32), torch.tensor(ctx, dtype=torch.int32, device="cuda")


def _mla_q(g, B, Q, H):
    return torch.randn(B, Q, H, MLA_DK, generator=g, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("H", [16, 128], ids=["v2_lite", "v3"])
@pytest.mark.parametrize("kind,Q,ctx", [("decode", 1, [640, 4096]),
                                        ("decode", 1, [63, 64, 65, 1]),
                                        ("decode", 1, [C - 1, C, C + 1]),
                                        ("decode", 1, [C - 40, 2 * C - 1, 2 * C, 3 * C + 1]),
                                        ("verify", 17, [4096, 70]),
                                        ("verify", 17, [C - 17, C - 16, C - 15]),
                                        ("verify", 129, [4096, 300]),
                                        ("prefill", 300, [0, 512]),
                                        ("prefill", 300, [C - 100, 2 * C - 1])])
def test_mla_attention(cuda, H, kind, Q, ctx):
    from painlessinferenceacceleration_tpu_torch.ops.mla_attention import (
        mla_paged_attention,
        mla_paged_attention_plain,
    )

    B = len(ctx)
    k, pt, ctx_t = _mla_arena(cuda, B, ctx, Q)
    q = _mla_q(cuda, B, Q, H)
    if kind == "verify":
        qm = _mask(cuda, B, Q)
    else:
        qm = causal_qmask(Q, "cuda")[None].expand(B, Q, Q).contiguous()
    scale = 0.0417
    before = mla_paged_attention.launches
    got = mla_paged_attention(q, k, pt, ctx_t, qm, scale, MLA_DV, causal=kind == "prefill")
    assert mla_paged_attention.launches == before + 1
    assert got.shape == (B, Q, H, MLA_DV) and torch.isfinite(got.float()).all()
    ref = mla_paged_attention_plain(q, k, pt, ctx_t, qm, scale, MLA_DV)
    assert _rel(got, ref) < 2e-2


@pytest.mark.parametrize("H", [16, 128], ids=["v2_lite", "v3"])
def test_mla_attention_rows_do_not_depend_on_the_width(cuda, H):
    """A row at Q = 1 equals the same row inside a 17-wide causal verify (a
    window inside a chunk and windows ending on both sides of a chunk
    edge), a 17-wide prefill (the causal flag), a 4096-row prefill (rows at
    the chunk edges) and a prefill resumed across an edge, bit for bit."""
    from painlessinferenceacceleration_tpu_torch.ops.mla_attention import (
        mla_paged_attention,
    )

    k, pt, _ = _mla_arena(cuda, 1, [4096], 17)
    one = torch.ones(1, 1, 1, dtype=torch.bool, device="cuda")
    qm = causal_qmask(17, "cuda")[None].contiguous()
    for c0 in (4000, C - 17, C - 16, 2 * C - 17):
        ctx0 = torch.tensor([c0], dtype=torch.int32, device="cuda")
        q = _mla_q(cuda, 1, 17, H)
        wide = mla_paged_attention(q, k, pt, ctx0, qm, 0.05, MLA_DV)
        pre = mla_paged_attention(q, k, pt, ctx0, None, 0.05, MLA_DV, causal=True)
        assert torch.equal(wide, pre)
        for t in (0, 5, 15, 16):
            row = mla_paged_attention(q[:, t:t + 1].contiguous(), k, pt, ctx0 + t, one, 0.05,
                                      MLA_DV)
            assert torch.equal(row, wide[:, t:t + 1]), (c0, t)
    if H == 16:  # 65 536 rows
        zero = torch.zeros(1, dtype=torch.int32, device="cuda")
        qp = _mla_q(cuda, 1, 4096, H)
        full = mla_paged_attention(qp, k, pt, zero, None, 0.05, MLA_DV, causal=True)
        for t in (0, 63, 64, C - 1, C, C + 1, 2 * C, 1000, 4095):
            row = mla_paged_attention(qp[:, t:t + 1].contiguous(), k, pt, zero + t, one, 0.05,
                                      MLA_DV)
            assert torch.equal(row, full[:, t:t + 1]), t
        c0 = 2 * C - 50  # a prefill chunk resumed across the edge at 2C
        part = mla_paged_attention(qp[:, c0:c0 + 200].contiguous(), k, pt, zero + c0, None,
                                   0.05, MLA_DV, causal=True)
        assert torch.equal(part, full[:, c0:c0 + 200])


_MLA_RANGE_CASES = [("decode", 1, [4096, 300]), ("decode", 1, [C - 1, 40]),
                    ("verify", 17, [4096, 70]), ("prefill", 512, [3584, 0]),
                    ("prefill", 300, [C - 100, 2 * C - 1])]


def _mla_range_call(q, k, pt, ctx_t, qm, kind, **kw):
    from painlessinferenceacceleration_tpu_torch.ops.mla_attention import (
        mla_paged_attention,
    )

    return mla_paged_attention(q, k, pt, ctx_t, qm, 0.0417, MLA_DV, causal=kind == "prefill",
                               **kw)


@pytest.mark.parametrize("kind,Q,ctx", _MLA_RANGE_CASES)
def test_mla_attention_page_range_and_lse_match_plain(cuda, kind, Q, ctx):
    """K13 with a page range and the rows' log-sum-exp, in each route (one
    chunk, the combine of decode and verify, the prefill walk), against
    ``mla_paged_attention_plain(page_range=, return_lse=)``: the output
    within rel 2e-2, the log-sum-exp within 2e-3 (natural log); rows that
    see no key in the range are 0 with -inf in both, and a range that
    holds none of a request's pages leaves its rows so."""
    from painlessinferenceacceleration_tpu_torch.ops.mla_attention import (
        mla_paged_attention,
        mla_paged_attention_plain,
    )

    B = len(ctx)
    k, pt, ctx_t = _mla_arena(cuda, B, ctx, Q)
    q = _mla_q(cuda, B, Q, 16)
    qm = (_mask(cuda, B, Q) if kind == "verify"
          else causal_qmask(Q, "cuda")[None].expand(B, Q, Q).contiguous())
    n = k.shape[0]
    for rng in ((1, n // 2), (n // 2, n), (n + 5, n + 9)):
        before = mla_paged_attention.modes[kind + ",range"]
        out, lse = _mla_range_call(q, k, pt, ctx_t, qm, kind, page_range=rng,
                                   return_lse=True)
        assert mla_paged_attention.modes[kind + ",range"] == before + 1
        ref, ref_lse = mla_paged_attention_plain(q, k, pt, ctx_t, qm, 0.0417, MLA_DV,
                                                 page_range=rng, return_lse=True)
        empty = torch.isinf(ref_lse)
        assert torch.equal(torch.isinf(lse), empty), rng
        assert torch.isneginf(lse[empty]).all() and (out[empty] == 0).all(), rng
        fin = ~empty
        if rng[0] >= n:
            assert empty.all()
        if fin.any():
            assert (lse[fin] - ref_lse[fin]).abs().max().item() < 2e-3, rng
            assert _rel(out, ref) < 2e-2, rng


@pytest.mark.parametrize("kind,Q,ctx", _MLA_RANGE_CASES)
def test_mla_attention_full_page_range_is_the_call_without_one(cuda, kind, Q, ctx):
    """The range [0, n_pages) (the RANGED build) gives the bits of the call
    without one, in every route, with the log-sum-exp asked for or not;
    the two ranks' partials over [0, n/2) and [n/2, n) merged lie within
    rel 2e-2 of the whole call."""
    from painlessinferenceacceleration_tpu_torch.ops.cp_attention import merge_partials

    B = len(ctx)
    k, pt, ctx_t = _mla_arena(cuda, B, ctx, Q)
    q = _mla_q(cuda, B, Q, 16)
    qm = (_mask(cuda, B, Q) if kind == "verify"
          else causal_qmask(Q, "cuda")[None].expand(B, Q, Q).contiguous())
    plain = _mla_range_call(q, k, pt, ctx_t, qm, kind)
    full, lse = _mla_range_call(q, k, pt, ctx_t, qm, kind, page_range=(0, k.shape[0]),
                                return_lse=True)
    assert torch.equal(full, plain)
    assert torch.equal(_mla_range_call(q, k, pt, ctx_t, qm, kind, return_lse=True)[0], plain)
    assert torch.isfinite(lse).all()
    n = k.shape[0]
    parts = [_mla_range_call(q, k, pt, ctx_t, qm, kind, page_range=r, return_lse=True)
             for r in ((0, n // 2), (n // 2, n))]
    got = merge_partials(torch.stack([p[0] for p in parts]),
                         torch.stack([p[1] for p in parts]))
    assert _rel(got, plain) < 2e-2


def test_mla_absorption_rows_do_not_depend_on_m(cuda):
    from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import (
        dense_matmul_batched,
        dense_matmul_batched_plain,
    )

    for K, N in ((128, 512), (512, 128)):  # q_nope . W_uk^T, then out . W_uv
        x = torch.randn(16, 4096, K, generator=cuda, device="cuda").to(torch.bfloat16)
        w = (torch.randn(16, K, N, generator=cuda, device="cuda") * 0.05).to(torch.bfloat16)
        before = dense_matmul_batched.launches
        full = dense_matmul_batched(x, w)
        assert dense_matmul_batched.launches == before + 1
        assert _rel(full, dense_matmul_batched_plain(x, w)) < 2e-2
        for m in (1, 17):
            assert torch.equal(dense_matmul_batched(x[:, :m].contiguous(), w), full[:, :m])
        # one head of the batch is the dense kernel on that head's weight
        assert torch.equal(dense_matmul(x[3, :17].contiguous(), w[3]), full[3, :17])


def test_mla_expanded_mode_raises_on_the_card(cuda):
    from painlessinferenceacceleration_tpu_torch.config import ModelConfig
    from painlessinferenceacceleration_tpu_torch.models.mla import mla_attn_block

    cfg = ModelConfig(model_type="deepseek_v2", hidden_size=64, num_attention_heads=4,
                      num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, mla_latent_cache=False)
    h = torch.zeros(1, 1, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(NotImplementedError, match="A.7"):
        mla_attn_block({}, 0, 0, cfg, None, h, None, None, {}, None, None, None, None, False)


def test_mla_model_serves_on_the_card(cuda):
    """A small bf16 DeepSeek-V2-shaped model through LLM: every layer goes
    through K13 and the absorption products, lookahead equals AR."""
    from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
    from painlessinferenceacceleration_tpu_torch.engine.llm import LLM
    from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams
    from painlessinferenceacceleration_tpu_torch.models.base import init_params
    from painlessinferenceacceleration_tpu_torch.ops.mla_attention import (
        mla_paged_attention,
    )

    cfg = ModelConfig(model_type="deepseek_v2", vocab_size=512, hidden_size=256,
                      intermediate_size=512, moe_intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                      kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128, moe_layer_start=1, num_experts=8,
                      num_experts_per_tok=2, num_shared_experts=2, norm_topk_prob=False,
                      mla_latent_cache=True)
    params = init_params(cfg, cuda, dtype=torch.bfloat16)
    prompts = [[5, 6, 7, 8] * 20, [9, 10, 11], list(range(40, 140))]
    outs = []
    for la in (False, True):
        ecfg = EngineConfig(page_size=64, max_seq_len=512, max_concurrency=4,
                            eos_token_id=-2, use_lookahead=la, decoding_length=16,
                            branch_length=16, use_spec_min_batch_size=4)
        before = dict(mla_paged_attention.modes)
        llm = LLM(cfg=cfg, params=params, ecfg=ecfg)
        outs.append([r.output_ids for r in llm.generate(prompts,
                                                         SamplingParams(max_new_tokens=24))])
        ran = {k for k, v in mla_paged_attention.modes.items() if v > before.get(k, 0)}
        assert ran >= ({"prefill", "verify"} if la else {"prefill", "decode"})
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# K15 (RMSNorm) and K14 (linear attention)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,shape,groups", [
    ("plain", (17, 2048), 1), ("plain", (3, 5, 16, 128), 1), ("group", (9, 2048), 16),
    ("gated", (9, 2048), 16), ("plain", (4096, 2048), 1)])
def test_rms_norm_kernel(cuda, kind, shape, groups, dtype):
    """K15 against the fp64-summed plain version: fp32 outputs within 4 ulp
    of the row's scale (the fp32 sum of squares in another order), bf16
    within one bf16 ulp (2^-7 relative: a value near a rounding boundary
    may round the other way)."""
    from painlessinferenceacceleration_tpu_torch.ops import rmsnorm as rn

    x = (torch.randn(*shape, generator=cuda, device="cuda") * 3).to(dtype)
    w = (1 + 0.3 * torch.randn(shape[-1], generator=cuda, device="cuda")).to(dtype)
    gate = torch.randn(*shape, generator=cuda, device="cuda").to(dtype)
    wrapper = {"plain": rn.rms_norm, "group": rn.rms_group_norm,
               "gated": rn.rms_group_norm_sigmoid}[kind]
    before = wrapper.launches
    if kind == "plain":
        got, ref = rn.rms_norm(x, w, 1e-6), rn.rms_norm_plain(x, w, 1e-6)
    elif kind == "group":
        got, ref = (rn.rms_group_norm(x, w, 1e-6, groups),
                    rn.rms_group_norm_plain(x, w, 1e-6, groups))
    else:
        got = rn.rms_group_norm_sigmoid(x, gate, w, 1e-6, groups)
        ref = rn.rms_group_norm_sigmoid_plain(x, gate, w, 1e-6, groups)
    assert wrapper.launches == before + 1 and got.dtype == dtype
    assert _rel(got, ref) <= (2 ** -7 if dtype == torch.bfloat16 else 5e-7)


def test_rms_norm_kernel_takes_strided_rows(cuda):
    """MLA normalises a slice of the kv_a product: rows with a stride."""
    from painlessinferenceacceleration_tpu_torch.ops.rmsnorm import rms_norm_plain

    kva = torch.randn(2, 7, 576, generator=cuda, device="cuda").to(torch.bfloat16)
    w = torch.ones(512, dtype=torch.bfloat16, device="cuda")
    assert _rel(rms_norm(kva[..., :512], w), rms_norm_plain(kva[..., :512], w)) <= 2 ** -7


@pytest.mark.parametrize("width,groups", [(2048, 1), (128, 1), (2048, 16)])
def test_rms_norm_rows_do_not_depend_on_the_batch(cuda, width, groups):
    from painlessinferenceacceleration_tpu_torch.ops.rmsnorm import rms_group_norm

    x = torch.randn(4096, width, generator=cuda, device="cuda").to(torch.bfloat16)
    w = torch.ones(width, dtype=torch.bfloat16, device="cuda")
    full = rms_group_norm(x, w, 1e-6, groups)
    for m in (1, 17, 512):
        assert torch.equal(rms_group_norm(x[:m], w, 1e-6, groups), full[:m])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width,groups", [
    (128, 1), (512, 1), (2048, 1), (4096, 1), (7168, 1), (2048, 16), (100, 1), (98, 1),
    (45, 1)])
def test_rms_norm_kernel_equals_the_replay_of_its_order(cuda, width, groups, dtype):
    """K15's plain and grouped kinds bit-equal to ``rms_norm_replay`` (its
    order of operations in fp32 torch ops on the CPU). Widths 100, 98 and
    45 end in a partial chunk, and in bf16 take one-element loads: the same
    order."""
    from painlessinferenceacceleration_tpu_torch.ops import rmsnorm as rn

    x = (torch.randn(37, width, generator=cuda, device="cuda") * 3).to(dtype)
    w = (1 + 0.3 * torch.randn(width, generator=cuda, device="cuda")).to(dtype)
    got = rn.rms_group_norm(x, w, 1e-6, groups) if groups > 1 else rn.rms_norm(x, w, 1e-6)
    assert torch.equal(got.cpu(), rn.rms_norm_replay(x.cpu(), w.cpu(), 1e-6, groups))


@pytest.mark.parametrize("offset", [1, 2, 4])
def test_rms_norm_kernel_keeps_its_order_on_narrower_loads(cuda, offset):
    """Rows that start 2, 4 or 8 bytes off a 16-byte boundary take
    one-element loads: the same bits as the aligned rows, and as the
    replay; an fp32 weight beside bf16 rows too."""
    from painlessinferenceacceleration_tpu_torch.ops import rmsnorm as rn

    wide = torch.randn(9, 2048 + 8, generator=cuda, device="cuda").to(torch.bfloat16)
    x = wide[:, offset:offset + 2048]
    for w in (torch.randn(2048, generator=cuda, device="cuda").to(torch.bfloat16),
              torch.randn(2048, generator=cuda, device="cuda")):
        got = rn.rms_norm(x, w, 1e-5)
        assert torch.equal(got, rn.rms_norm(x.contiguous(), w, 1e-5))
        assert torch.equal(got.cpu(), rn.rms_norm_replay(x.cpu(), w.cpu(), 1e-5))


def _la_inputs(g, B, H, C, D, scale=0.5):
    q, k, v = (torch.randn(B, H, C, D, generator=g, device="cuda") * scale for _ in range(3))
    return torch.nn.functional.silu(q), torch.nn.functional.silu(k), v


def _loglam(H):
    from painlessinferenceacceleration_tpu_torch.models.linear_attn import (
        default_decays,
        loglam_of,
    )

    return loglam_of(default_decays(H, "cuda"))


@pytest.mark.parametrize("C,lens", [(1, [1, 0]), (17, [17, 9]), (100, [100, 64]),
                                    (512, [512, 300])])
def test_linear_attention_chunk_kernel(cuda, C, lens):
    """K14 chunk mode against its plain version (the same sub-tiles; dot
    products summed in another order: 1e-5 of the largest value), over
    slot rows of an arena with a carried state; a row with chunk_lens 0
    aliasing another row's slot leaves it alone."""
    from painlessinferenceacceleration_tpu_torch.ops import linear_attention as la

    B, H, D = 3, 4, 128
    q, k, v = _la_inputs(cuda, B, H, C, D)
    arena = torch.randn(4, H, D, D, generator=cuda, device="cuda") * 0.1
    slots = torch.tensor([2, 0, 2], dtype=torch.int32, device="cuda")
    n = torch.tensor(lens + [0], dtype=torch.int32, device="cuda")
    ref_arena = arena.clone()
    before = la.linear_attention_chunk.launches
    out, _ = la.linear_attention_chunk(q, k, v, arena, n, _loglam(H), slots)
    ref, _ = la.linear_attention_chunk_plain(q, k, v, ref_arena, n, _loglam(H), slots)
    assert la.linear_attention_chunk.launches == before + 1
    assert _rel(out, ref) <= 1e-5 and _rel(arena, ref_arena) <= 1e-5
    assert torch.equal(arena[[1, 3]], ref_arena[[1, 3]])  # untouched slots
    assert not out[2].any() and not out[1, :, lens[1]:].any()


def _tree(B, R, L, dead=()):
    """Parallel-branch parents and liveness (lookahead/device_tables.py)."""
    from painlessinferenceacceleration_tpu_torch.lookahead.device_tables import (
        build_tree_inputs,
    )

    br = torch.arange(10, 10 + R * L, device="cuda").reshape(R, L).repeat(B, 1, 1)
    for b, n in enumerate(dead):
        if n:
            br[b, -1, L - n:] = -1
    _, parents, qmask, _ = build_tree_inputs(torch.ones(B, dtype=torch.int32,
                                                        device="cuda"), br)
    return parents, parents > -2, qmask


@pytest.mark.parametrize("R,L", [(1, 16), (2, 8)])
def test_linear_attention_recurrent_modes_equal_plain_bit_for_bit(cuda, R, L):
    """Decode, tree and commit repeat their plain versions' arithmetic
    operation for operation: equal bits; an inactive row writes nothing."""
    from painlessinferenceacceleration_tpu_torch.ops import linear_attention as la

    B, H, D = 3, 16, 128
    Q = 1 + R * L
    q, k, v = _la_inputs(cuda, B, H, Q, D)
    s = torch.randn(B, H, D, D, generator=cuda, device="cuda") * 0.1
    ll = _loglam(H)
    parents, valid, _ = _tree(B, R, L, dead=(0, 3, 0))
    valid[2] = False  # an inactive row
    out = la.linear_attention_tree(q, k, v, s, parents, valid, ll)
    assert torch.equal(out, la.linear_attention_tree_plain(q, k, v, s, parents, valid, ll))
    one = valid[:, :1]
    s1, s2 = s.clone(), s.clone()
    o1, _ = la.linear_attention_decode(q[:, :, :1], k[:, :, :1], v[:, :, :1], s1, one, ll)
    o2, _ = la.linear_attention_decode_plain(q[:, :, :1], k[:, :, :1], v[:, :, :1], s2,
                                             one, ll)
    assert torch.equal(o1, o2) and torch.equal(s1, s2) and torch.equal(s1[2], s[2])
    chain = torch.cat([torch.zeros(B, 1, dtype=torch.long, device="cuda"),
                       1 + torch.arange(L, device="cuda").repeat(B, 1)], dim=1)
    n = torch.tensor([L + 1, 4, 0], device="cuda")
    arena = torch.randn(2, 4, H, D, D, generator=cuda, device="cuda") * 0.1
    ref = arena.clone()
    slots = torch.tensor([3, 1, 3], device="cuda")
    wk, wv = torch.stack([k, k * 0.5]), torch.stack([v, v * 2])
    lls = torch.stack([ll, ll * 0.5])
    la.linear_attention_commit(arena, wk, wv, chain, n, lls, slots)
    la.linear_attention_commit_plain(ref, wk, wv, chain, n, lls, slots)
    assert torch.equal(arena, ref)


def test_verify_rows_and_commit_equal_ar_on_the_card(cuda):
    """A verified node's row equals the AR decode row at its position, and
    the state after committing n accepted nodes equals n AR steps."""
    from painlessinferenceacceleration_tpu_torch.ops import linear_attention as la

    B, H, D, R, L = 1, 16, 128, 2, 8
    q, k, v = _la_inputs(cuda, B, H, 1 + R * L, D)
    s0 = torch.randn(B, H, D, D, generator=cuda, device="cuda") * 0.1
    ll = _loglam(H)
    parents, valid, _ = _tree(B, R, L)
    tree = la.linear_attention_tree(q, k, v, s0, parents, valid, ll)
    chain = [0] + list(range(1 + L, 1 + 2 * L))  # the root, then branch 1
    s_ar, rows = s0.clone(), []
    for c in chain:
        o, _ = la.linear_attention_decode(q[:, :, c:c + 1].contiguous(),
                                          k[:, :, c:c + 1].contiguous(),
                                          v[:, :, c:c + 1].contiguous(), s_ar,
                                          valid[:, :1], ll)
        rows.append(o)
    assert torch.equal(torch.cat(rows, dim=2), tree[:, :, chain])
    for n in (1, 5, len(chain)):
        arena = s0[None].clone()
        la.linear_attention_commit(arena, k[None], v[None],
                                   torch.tensor([chain], device="cuda"),
                                   torch.tensor([n], device="cuda"), ll[None],
                                   torch.zeros(1, dtype=torch.int32, device="cuda"))
        s_n = s0.clone()
        for c in chain[:n]:
            la.linear_attention_decode(q[:, :, c:c + 1].contiguous(),
                                       k[:, :, c:c + 1].contiguous(),
                                       v[:, :, c:c + 1].contiguous(), s_n, valid[:, :1], ll)
        assert torch.equal(arena[0], s_n), n


def test_linear_attention_chunk_rows_do_not_depend_on_the_batch(cuda):
    """A chunk row's output and state bits depend on its own tokens only:
    the same 700 tokens alone (C = 700), as row 1 of a batch of 3 with 300
    and 1000 tokens at C = 1000 (strided views of wider tensors, int64
    lengths), and on a slot of an arena."""
    from painlessinferenceacceleration_tpu_torch.ops import linear_attention as la

    H, D, n = 16, 128, 700
    q, k, v = _la_inputs(cuda, 3, H, 1024, D)
    s0 = torch.randn(3, H, D, D, generator=cuda, device="cuda") * 0.1
    ll = _loglam(H)
    st_b = s0.clone()
    out_b, _ = la.linear_attention_chunk(*(t[:, :, :1000] for t in (q, k, v)), st_b,
                                         torch.tensor([300, n, 1000], device="cuda"), ll)
    st_1 = s0[1:2].clone()
    out_1, _ = la.linear_attention_chunk(*(t[1:2, :, :n].contiguous() for t in (q, k, v)), st_1,
                                         torch.tensor([n], dtype=torch.int32, device="cuda"), ll)
    assert torch.equal(out_b[1, :, :n], out_1[0]) and torch.equal(st_b[1], st_1[0])
    assert not out_b[1, :, n:].any() and not out_b[0, :, 300:].any()
    arena = torch.randn(4, H, D, D, generator=cuda, device="cuda") * 0.1
    arena[3] = s0[1]
    out_s, _ = la.linear_attention_chunk(*(t[1:2, :, :n].contiguous() for t in (q, k, v)), arena,
                                         torch.tensor([n], dtype=torch.int32, device="cuda"), ll,
                                         torch.tensor([3], dtype=torch.int32, device="cuda"))
    assert torch.equal(out_s, out_1) and torch.equal(arena[3], st_1[0])


def test_linear_attention_chunk_resumes_bit_for_bit(cuda):
    """A 1024-token chunk equals the same tokens as two 512-token chunks (a
    prefill resumed at a multiple of the 64-token tile), output and state."""
    from painlessinferenceacceleration_tpu_torch.ops import linear_attention as la

    H, D = 16, 128
    q, k, v = _la_inputs(cuda, 1, H, 1024, D)
    s0 = torch.randn(1, H, D, D, generator=cuda, device="cuda") * 0.1
    ll = _loglam(H)
    whole, parts = s0.clone(), s0.clone()
    out_w, _ = la.linear_attention_chunk(q, k, v, whole,
                                         torch.tensor([1024], dtype=torch.int32, device="cuda"),
                                         ll)
    outs = [la.linear_attention_chunk(*(t[:, :, c:c + 512] for t in (q, k, v)), parts,
                                      torch.tensor([512], dtype=torch.int32, device="cuda"),
                                      ll)[0] for c in (0, 512)]
    assert torch.equal(out_w, torch.cat(outs, dim=2)) and torch.equal(whole, parts)


def test_linear_attention_ring_layers_verify_and_commit_equal_ar(cuda):
    """At Ring-mini-linear-2.0's 16 linear layers (each its own decay and
    stash): every verified node's row equals the AR row at its position, and
    committing n accepted nodes leaves every layer's slot equal to n AR
    steps."""
    from painlessinferenceacceleration_tpu_torch.ops import linear_attention as la

    n_lin, H, D, R, L = 16, 16, 128, 2, 8
    Q = 1 + R * L
    q, k, v = _la_inputs(cuda, n_lin, H, Q, D)  # one window per layer
    arena = torch.randn(n_lin, 3, H, D, D, generator=cuda, device="cuda") * 0.1
    lls = torch.stack([_loglam(H) * (1 + 0.05 * i) for i in range(n_lin)])
    parents, valid, _ = _tree(1, R, L)
    slot = torch.tensor([2], dtype=torch.int32, device="cuda")
    chain = [0] + list(range(1 + L, 1 + 2 * L))  # the root, then branch 1
    ar = arena.clone()
    for i in range(n_lin):
        tree = la.linear_attention_tree(q[i:i + 1], k[i:i + 1], v[i:i + 1], arena[i], parents,
                                        valid, lls[i], slot)
        for c in chain:
            o, _ = la.linear_attention_decode(*(t[i:i + 1, :, c:c + 1] for t in (q, k, v)), ar[i],
                                              valid[:, :1], lls[i], slot)
            assert torch.equal(o[0, :, 0], tree[0, :, c]), (i, c)
    for n in (1, 5, len(chain)):
        committed = arena.clone()
        la.linear_attention_commit(committed, k[:, None], v[:, None],
                                   torch.tensor([chain], device="cuda"),
                                   torch.tensor([n], device="cuda"), lls, slot)
        for i in range(n_lin):
            s_n = arena[i].clone()
            for c in chain[:n]:
                la.linear_attention_decode(*(t[i:i + 1, :, c:c + 1] for t in (q, k, v)), s_n,
                                           valid[:, :1], lls[i], slot)
            assert torch.equal(committed[i], s_n), (n, i)
        assert torch.equal(committed[:, :2], arena[:, :2])  # other slots untouched


@pytest.mark.parametrize("D", [64, 128])
def test_linear_attention_recurrent_modes_at_strided_inputs(cuda, D):
    """Decode and tree on strided views with int64 indices and a slot arena
    equal their plain versions bit for bit (the card hybrid's D = 64 and
    Ring's 128)."""
    from painlessinferenceacceleration_tpu_torch.ops import linear_attention as la

    B, H, R, L = 2, 4, 2, 4
    Q = 1 + R * L
    q, k, v = (t[..., :D] for t in _la_inputs(cuda, B, H, Q, D + 16))
    arena = torch.randn(3, H, D, D, generator=cuda, device="cuda") * 0.1
    ll = _loglam(H)
    slots = torch.tensor([2, 0], device="cuda")
    parents, valid, _ = _tree(B, R, L, dead=(0, 2))
    got = la.linear_attention_tree(q, k, v, arena, parents.long(), valid, ll, slots)
    assert torch.equal(got, la.linear_attention_tree_plain(q, k, v, arena, parents, valid, ll,
                                                           slots))
    a1, a2 = arena.clone(), arena.clone()
    o1, _ = la.linear_attention_decode(q[:, :, 3:4], k[:, :, 3:4], v[:, :, 3:4], a1,
                                       valid[:, 3:4], ll, slots)
    o2, _ = la.linear_attention_decode_plain(q[:, :, 3:4], k[:, :, 3:4], v[:, :, 3:4], a2,
                                             valid[:, 3:4], ll, slots)
    assert torch.equal(o1, o2) and torch.equal(a1, a2)


def test_linear_attention_one_kernel_a_call(cuda):
    """Each K14 call is one CUDA kernel (chunk mode three: the tiles'
    increments, the carry over the tiles, the outputs), no other kernel
    beside it (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from painlessinferenceacceleration_tpu_torch.ops import linear_attention as la

    B, H, D, Q = 2, 16, 128, 17
    q, k, v = _la_inputs(cuda, B, H, Q, D)
    arena = torch.randn(3, H, D, D, generator=cuda, device="cuda") * 0.1
    arenas = torch.randn(2, 3, H, D, D, generator=cuda, device="cuda") * 0.1
    ll = _loglam(H)
    lls = torch.stack([ll, ll * 0.5])
    slots = torch.tensor([1, 2], dtype=torch.int32, device="cuda")
    parents, valid, _ = _tree(B, 2, 8)
    lens = torch.tensor([Q, 9], dtype=torch.int32, device="cuda")
    win_k, win_v = torch.stack([k, k]), torch.stack([v, v])
    chain = torch.arange(Q, device="cuda").repeat(B, 1)
    n_commit = torch.tensor([5, 3], device="cuda")
    cases = [
        ("chunk", 3, lambda: la.linear_attention_chunk(q, k, v, arena, lens, ll, slots)),
        ("decode", 1, lambda: la.linear_attention_decode(q[:, :, :1], k[:, :, :1], v[:, :, :1],
                                                         arena, valid[:, :1], ll, slots)),
        ("tree", 1, lambda: la.linear_attention_tree(q, k, v, arena, parents, valid, ll, slots)),
        ("commit", 1, lambda: la.linear_attention_commit(arenas, win_k, win_v, chain, n_commit,
                                                         lls, slots)),
    ]
    for mode, want, fn in cases:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        assert kernels == want, (mode, kernels)


def _tiny_hybrid():
    from painlessinferenceacceleration_tpu_torch.config import ModelConfig

    return ModelConfig(model_type="bailing_moe_linear_v2", vocab_size=512, hidden_size=256,
                       intermediate_size=512, moe_intermediate_size=128,
                       num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                       head_dim=64, rms_norm_eps=1e-6, rope_theta=600000.0, qk_norm=True,
                       linear_attention=True, layer_group_size=2, linear_qk_norm=True,
                       linear_rope=True, num_experts=8, num_experts_per_tok=2,
                       num_shared_experts=1, moe_layer_start=1, scoring_func="sigmoid",
                       n_group=4, topk_group=2, routed_scaling_factor=2.5)


def test_hybrid_teacher_forced_lookahead_equals_ar_bit_for_bit(cuda):
    """A bf16 hybrid on the card: teacher-forced lookahead (multi-token
    commits) and teacher-forced AR over the same stream leave every linear
    layer's state and the full layers' KV rows with the same bits."""
    from painlessinferenceacceleration_tpu_torch.config import EngineConfig
    from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache
    from painlessinferenceacceleration_tpu_torch.engine.multistep import (
        multistep_decode,
        multistep_spec_decode,
    )
    from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step
    from painlessinferenceacceleration_tpu_torch.lookahead import device_tables as dt
    from painlessinferenceacceleration_tpu_torch.models.base import init_params

    cfg = _tiny_hybrid()
    params = init_params(cfg, cuda, dtype=torch.bfloat16)
    ecfg = EngineConfig(page_size=64, max_seq_len=512, max_concurrency=2)
    teacher = torch.arange(100, 164, device="cuda").repeat(6)[None].to(torch.int32)
    P0 = 96
    pt = torch.arange(1, 1 + ecfg.pages_per_req, dtype=torch.int32, device="cuda")[None]
    slot = torch.ones(1, dtype=torch.int32, device="cuda")
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    ctx0 = torch.tensor([P0], dtype=torch.int32, device="cuda")

    def prefill():
        kv = init_kv_cache(cfg, ecfg)
        kv, _, _ = prefill_step(params, kv, cfg, teacher[:, :P0],
                                torch.zeros(1, dtype=torch.int32, device="cuda"), ctx0, pt,
                                slot_ids=slot)
        return kv

    tcfg = dt.DraftTableConfig(buckets=1024, ways=4, branch_length=16, retrieve_count=1)
    tables = dt.init_draft_tables(tcfg)
    dt.update_tables_seq(tables, tcfg, teacher[0, :P0], P0)
    kv_la = prefill()
    out = multistep_spec_decode(params, kv_la, tables, cfg, tcfg, teacher[:, P0], ctx0, one,
                                teacher[:, P0 - 17: P0 + 1], pt, n_steps=8, teacher=teacher,
                                update_tables=False, slot_ids=slot)
    n_tok = int(out[5][0]) - P0
    assert n_tok > 16, "drafts never landed"
    kv_ar = prefill()
    multistep_decode(params, kv_ar, cfg, teacher[:, P0], ctx0, one, pt, n_steps=n_tok,
                     teacher=teacher, slot_ids=slot)
    assert torch.equal(kv_la["s"], kv_ar["s"]) and kv_ar["s"][:, 1].any()
    ctx = P0 + n_tok
    pages = pt[0, : -(-ctx // 64)].long()
    for name in ("k", "v"):
        a = kv_la[name][:, pages].reshape(kv_la[name].shape[0], -1, kv_la[name].shape[-1])
        b = kv_ar[name][:, pages].reshape(a.shape)
        assert torch.equal(a[:, :ctx], b[:, :ctx]), name


def test_hybrid_model_serves_on_the_card(cuda):
    """The bf16 hybrid through LLM: lookahead equals AR, a request served
    again alone equals its batched self (slots are reused: 6 requests over
    2 slots), and every K14 mode and K15's plain and gated kinds ran."""
    from painlessinferenceacceleration_tpu_torch.config import EngineConfig
    from painlessinferenceacceleration_tpu_torch.engine.llm import LLM
    from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams
    from painlessinferenceacceleration_tpu_torch.models.base import init_params
    from painlessinferenceacceleration_tpu_torch.ops import linear_attention as la
    from painlessinferenceacceleration_tpu_torch.ops import rmsnorm as rn

    cfg = _tiny_hybrid()
    params = init_params(cfg, cuda, dtype=torch.bfloat16)
    prompts = [[5, 6, 7, 8] * 20, [9, 10, 11], list(range(40, 140)), [7] * 30,
               list(range(200, 290)), [11, 12] * 9]
    outs = []
    wrappers = [getattr(la, f"linear_attention_{m}") for m in ("chunk", "decode", "tree",
                                                                "commit")]
    wrappers += [rn.rms_norm, rn.rms_group_norm_sigmoid]
    before = [f.launches for f in wrappers]

    def serve(ps, lookahead, conc=2):
        ecfg = EngineConfig(page_size=64, max_seq_len=512, max_concurrency=conc,
                            eos_token_id=-2, use_lookahead=lookahead, decoding_length=16,
                            branch_length=16, use_spec_min_batch_size=4)
        llm = LLM(cfg=cfg, params=params, ecfg=ecfg)
        res = [r.output_ids for r in llm.generate(ps, SamplingParams(max_new_tokens=24))]
        assert llm.metrics.prefix_hit_tokens == 0
        return res

    for lookahead in (False, True):
        outs.append(serve(prompts, lookahead))
    assert outs[0] == outs[1]
    for i in (2, 5):
        assert serve([prompts[i]], False, 1)[0] == outs[0][i]
    assert all(f.launches > b for f, b in zip(wrappers, before))


# ---------------------------------------------------------------------------
# K16 (kv_write_rows) and K17 (kv_move_rows)
# ---------------------------------------------------------------------------

# (arena kind, the arenas' element type and row widths)
ROW_KINDS = {
    "bf16": (torch.bfloat16, (4096, 4096)),
    "e4m3": (torch.float8_e4m3fn, (4096, 4096)),
    "fp8_tok": (torch.float8_e4m3fn, (4096, 4096), torch.float32, (32, 32)),
    "scales_4_heads": (torch.float32, (4, 4)),
    "mla": (torch.bfloat16, (576, 512)),
    "tiny_fp32": (torch.float32, (6, 3)),  # 24 / 12 bytes: 4-byte copies
}


def _row_case(g, kind, N, L=3, n_pages=9, ps=64, dup=True):
    """Arenas and rows of ``kind`` for N rows, with duplicates on the null
    page (every fourth row) and one non-null destination named twice."""
    spec = ROW_KINDS[kind]
    pairs = [(spec[0], w) for w in spec[1]]
    if len(spec) > 2:
        pairs += [(spec[2], w) for w in spec[3]]
    pages, rows = [], []
    for dtype, w in pairs:
        pages.append(torch.randn(L, n_pages, ps, w, generator=g, device="cuda").to(dtype))
        rows.append(torch.randn(N, w, generator=g, device="cuda").to(dtype))
    slot = torch.randperm((n_pages - 1) * ps, generator=g, device="cuda")[:N]
    pi, ri = (slot // ps + 1).to(torch.int32), (slot % ps).to(torch.int32)
    if dup and N > 1:
        pi[::4] = 0
        pi[-1], ri[-1] = pi[N // 2], ri[N // 2]
    return pages, rows, pi, ri


@pytest.mark.parametrize("kind", list(ROW_KINDS))
@pytest.mark.parametrize("N", [1, 64, 513, 4096])
def test_kv_write_rows(cuda, kind, N):
    from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
        kv_write_rows,
        kv_write_rows_plain,
    )

    n_pages = 4096 // 64 + 2
    pages, rows, pi, ri = _row_case(cuda, kind, N, n_pages=n_pages)
    ref = kv_write_rows_plain(tuple(p.clone() for p in pages), tuple(rows), pi, ri, 1)
    before = kv_write_rows.launches
    got = kv_write_rows(tuple(p.clone() for p in pages), tuple(rows), pi, ri, 1)
    assert kv_write_rows.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_kv_write_rows_takes_strided_rows(cuda):
    """V rows as a view of the fused qkv output (a row stride of 3 rows)."""
    from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
        kv_write_rows,
        kv_write_rows_plain,
    )

    qkv = torch.randn(70, 3 * 1024, generator=cuda, device="cuda").to(torch.bfloat16)
    rows = qkv[:, 2048:]
    pages = torch.randn(2, 4, 64, 1024, generator=cuda, device="cuda").to(torch.bfloat16)
    pi = torch.randint(0, 4, (70,), generator=cuda, device="cuda", dtype=torch.int32)
    ri = torch.randint(0, 64, (70,), generator=cuda, device="cuda", dtype=torch.int32)
    got = kv_write_rows(pages.clone(), rows, pi, ri, 1)
    assert torch.equal(got, kv_write_rows_plain(pages.clone(), rows, pi, ri, 1))


def _step_case(g, kind, B, Q, holes, L=3, ps=64):
    """Arenas of ``kind`` and a step's K / V as the models pass them (V a
    view of a fused projection), contexts of 0-539 tokens."""
    H, D, Dv = (1, 576, 512) if kind == "mla" else (8, 128, 128)
    P = (540 + Q) // ps + 2
    n_pages = B * P + 1
    dt = torch.float8_e4m3fn if kind in ("fp8", "fp8_tok") else torch.bfloat16
    arenas = tuple(torch.randn(L, n_pages, ps, H * w, generator=g, device="cuda").to(dt)
                   for w in (D, Dv))
    if kind == "fp8_tok":
        arenas += tuple(torch.rand(L, n_pages, ps, H, generator=g, device="cuda")
                        for _ in range(2))
    nk = (torch.randn(B, Q, H, D, generator=g, device="cuda") * 3).to(torch.bfloat16)
    fused = (torch.randn(B, Q, H * (D + Dv), generator=g, device="cuda") * 3).to(torch.bfloat16)
    nv = fused[..., H * D:].reshape(B, Q, H, Dv)
    pt = (torch.randperm(B * P, generator=g, device="cuda") + 1).reshape(B, P).to(torch.int32)
    start = torch.randint(0, 540, (B,), generator=g, device="cuda")
    valid = torch.ones(B, Q, dtype=torch.bool, device="cuda")
    if holes:
        valid[:, 2::5] = False
    ks = vs = None
    if kind == "fp8":
        ks, vs = (torch.rand(H, generator=g, device="cuda") * 0.01 + 0.002 for _ in range(2))
    return arenas, nk, nv, pt, start, valid, ks, vs


@pytest.mark.parametrize("kind", ["bf16", "fp8", "fp8_tok", "mla"])
@pytest.mark.parametrize("B,Q,holes", [(1, 1, False), (1, 17, True), (1, 64, True),
                                       (8, 17, True), (8, 512, True)])
def test_kv_write_step(cuda, kind, B, Q, holes):
    """K16's step entry equals its plain version (the eager route) byte for
    byte outside the null page, where only the plain version writes the
    invalid tokens, in one launch."""
    from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
        kv_write_step,
        kv_write_step_plain,
    )

    arenas, nk, nv, pt, start, valid, ks, vs = _step_case(cuda, kind, B, Q, holes)
    before = kv_write_step.launches
    got = kv_write_step(tuple(a.clone() for a in arenas), nk, nv, pt, start, valid, 1, ks, vs)
    assert kv_write_step.launches == before + 1
    ref = kv_write_step_plain(tuple(a.clone() for a in arenas), nk, nv, pt, start, valid, 1,
                              ks, vs)
    for a, b in zip(got, ref):
        assert torch.equal(a[:, 1:].view(torch.uint8), b[:, 1:].view(torch.uint8))


def test_kv_write_step_past_the_end_of_a_page_table(cuda):
    """Tokens past the end of their page table (page index clamped to the
    last) name the rows of earlier ones: the later valid token's row is
    kept, as in the eager route; int64 indices read as they come."""
    from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
        kv_write_step,
        kv_write_step_plain,
    )

    arenas, nk, nv, pt, start, valid, ks, vs = _step_case(cuda, "bf16", 2, 200, True)
    pt, start = pt[:, :2].long(), torch.tensor([40, 0], device="cuda")
    got = kv_write_step(tuple(a.clone() for a in arenas), nk, nv, pt, start, valid, 1)
    ref = kv_write_step_plain(tuple(a.clone() for a in arenas), nk, nv, pt, start, valid, 1)
    for a, b in zip(got, ref):
        assert torch.equal(a[:, 1:].view(torch.uint8), b[:, 1:].view(torch.uint8))


def _move_case(g, L, n_pages, ps, row, dtype, N, chains=True):
    pages = torch.randn(L, n_pages, ps, row, generator=g, device="cuda").to(dtype)
    slots = torch.randperm(n_pages * ps, generator=g, device="cuda")
    src, dst = slots[:N].clone(), slots[N: 2 * N].clone()
    if chains and N > 2:
        dst[1: N // 2] = src[: N // 2 - 1]  # a move's destination is an earlier source
        src[N // 2 + 1:] = dst[N // 2: N - 1]  # a move reads an earlier destination
        dst[-1] = dst[0]  # one destination twice: the later move is kept
    idx = [(t // ps).to(torch.int32) for t in (src, dst)]
    rows = [(t % ps).to(torch.int32) for t in (src, dst)]
    return pages, idx[0], rows[0], idx[1], rows[1]


@pytest.mark.parametrize("dtype,row", [(torch.bfloat16, 4096), (torch.float8_e4m3fn, 4096),
                                       (torch.float32, 4), (torch.bfloat16, 576),
                                       (torch.float32, 3), (torch.float32, 9)])
@pytest.mark.parametrize("N", [1, 12, 63, 252, 1024])
def test_kv_move_rows(cuda, dtype, row, N):
    """Rows of 8192, 1152, 36, 16 and 12 bytes (bulk copies, 4-byte
    words), chains and a destination named twice."""
    from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
        kv_move_rows,
        kv_move_rows_plain,
    )

    n_pages = max(20, 2 * N // 64 + 1)
    pages, sp, sr, dp, dr = _move_case(cuda, 32 if row == 4096 else 4, n_pages, 64, row,
                                       dtype, N)
    before = kv_move_rows.launches
    got = kv_move_rows(pages.clone(), sp, sr, dp, dr)
    assert kv_move_rows.launches == before + 1
    ref = kv_move_rows_plain(pages.clone(), sp, sr, dp, dr)
    assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.parametrize("B,M,offset", [(4, 63, 0), (8, 16, 0), (4, 63, 4), (2, 5, 1)])
def test_kv_move_rows_batch_paths_with_masked_moves(cuda, B, M, offset):
    """B requests' accepted paths (rows shift down: chains), each request's
    last move masked to the null page 0 (named B times), 8192-byte rows, on
    a base off the 16-byte grid where ``offset`` says (the 4-byte and byte
    loops)."""
    from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
        kv_move_rows,
        kv_move_rows_plain,
    )

    L, ps, row, P = 4, 64, 8192, 6
    n = L * (B * P + 1) * ps * row
    buf = torch.randint(0, 256, (n + 16,), generator=cuda, device="cuda", dtype=torch.uint8)
    pages = buf[offset: offset + n].view(L, B * P + 1, ps, row)
    sp, sr, dp, dr = [], [], [], []
    for b in range(B):
        pt = torch.arange(1 + b * P, 1 + (b + 1) * P, device="cuda")
        ctx = int(torch.randint(0, (P - 2) * ps, (1,), generator=cuda, device="cuda"))
        path = torch.sort(torch.randperm(2 * M, generator=cuda, device="cuda")[:M] + 1)[0]
        src, dst = ctx + path, ctx + 1 + torch.arange(M, device="cuda")
        dpage = pt[dst // ps].clone()
        dpage[-1] = 0
        sp.append(pt[src // ps])
        sr.append(src % ps)
        dp.append(dpage)
        dr.append(dst % ps)
    idx = [torch.cat(x) for x in (sp, sr, dp, dr)]  # int64: the wrapper converts
    ref = kv_move_rows_plain(pages.clone(), *idx)
    before = kv_move_rows.launches
    got = kv_move_rows(pages, *idx)
    assert kv_move_rows.launches == before + 1
    assert torch.equal(got, ref)


def test_kv_move_rows_refuses_past_shared_memory(cuda):
    from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
        MAX_MOVES,
        kv_move_rows,
    )

    pages, sp, sr, dp, dr = _move_case(cuda, 2, 40, 64, 8, torch.float32, MAX_MOVES + 1,
                                       chains=False)
    with pytest.raises(ValueError, match="kv_move_rows"):
        kv_move_rows(pages, sp, sr, dp, dr)
    # 1024 moves of 4-byte rows with a 4-byte unit fit (4 KB of slices)
    pages, sp, sr, dp, dr = _move_case(cuda, 2, 40, 64, 1, torch.float32, MAX_MOVES,
                                       chains=False)
    kv_move_rows(pages, sp, sr, dp, dr)
    torch.cuda.synchronize()


def test_write_kv_pages_and_move_kv_rows_launch_the_kernels(cuda):
    from painlessinferenceacceleration_tpu_torch.engine.cache import (
        compact_kv_tail,
        move_kv_rows,
        write_kv_pages,
    )
    from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
        kv_move_rows,
        kv_write_step,
    )

    L, n_pages, ps, H, D = 2, 9, 64, 2, 64
    B, Q = 2, 17
    k = torch.randn(L, n_pages, ps, H * D, generator=cuda, device="cuda").to(torch.bfloat16)
    v = k.clone()
    pt = torch.arange(1, 9, dtype=torch.int32, device="cuda").reshape(B, 4)
    start = torch.tensor([70, 5], dtype=torch.int32, device="cuda")
    nk = torch.randn(B, Q, H, D, generator=cuda, device="cuda").to(torch.bfloat16)
    valid = torch.ones(B, Q, dtype=torch.bool, device="cuda")
    valid[1, 9:] = False
    before = kv_write_step.launches
    write_kv_pages(k, v, nk, nk, pt, start, valid, 1)
    assert kv_write_step.launches == before + 1  # K and V in one launch
    flat = k[1][pt[0].long()].reshape(-1, H * D)
    assert torch.equal(flat[70: 70 + Q], nk[0].reshape(Q, -1))
    # the accepted path's moves equal compact_kv_tail on the live slots
    path = torch.tensor([[3, 7, 8, 12], [2, 5, 0, 0]], dtype=torch.int32, device="cuda")
    n_edges = torch.tensor([4, 2], dtype=torch.int32, device="cuda")
    a = compact_kv_tail(k.clone(), pt, start, path, n_edges, Q)
    i = torch.arange(4, device="cuda")[None]
    before = kv_move_rows.launches
    b = move_kv_rows(k.clone(), pt, start[:, None] + path, start[:, None] + 1 + i,
                     i < n_edges[:, None])
    assert kv_move_rows.launches == before + 1
    for r in range(B):
        n = int(start[r]) + 1 + int(n_edges[r])
        rows = lambda x: x[:, pt[r].long()].reshape(L, -1, H * D)[:, :n]  # noqa: E731
        assert torch.equal(rows(a), rows(b))


def test_generator_lookahead_equals_ar_on_the_card(cuda):
    """A small bf16 llama through LookaheadGenerator: hier, par and one
    lookahead and batch_generate give the AR stream; the native trie is
    the one in use."""
    from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
    from painlessinferenceacceleration_tpu_torch.lookahead.generate import LookaheadGenerator
    from painlessinferenceacceleration_tpu_torch.lookahead.native import NativeDraftCache
    from painlessinferenceacceleration_tpu_torch.models.base import init_params

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    params = init_params(cfg, cuda, dtype=torch.bfloat16)
    ecfg = EngineConfig(page_size=64, max_seq_len=512, max_concurrency=4, eos_token_id=-2,
                        decoding_length=63, branch_length=12)
    gen = LookaheadGenerator(params, cfg, ecfg)
    assert isinstance(gen.trie, NativeDraftCache)
    prompts = [[5, 6, 7, 8] * 20, [9, 10, 11] * 7, list(range(40, 140)), [7, 8] * 15]
    ar = [gen.generate(p, max_new_tokens=64, use_lookahead=False).sequences for p in prompts]
    for mode in ("hier", "par", "one"):
        la = gen.generate(prompts[0], max_new_tokens=64, use_lookahead=True,
                          decoding_mode=mode)
        assert la.sequences == ar[0], mode
    assert max(la.edls) > 1
    assert [o.sequences for o in gen.batch_generate(prompts, max_new_tokens=64)] == ar


SAMPLER_SETTINGS = [(0.8, 50, 0.95, 0.0), (1.0, 0, 1.0, 0.0), (0.7, 0, 0.9, 0.05),
                    (1.2, 1, 1.0, 0.0), (0.0, 0, 1.0, 0.0)]


@pytest.mark.parametrize("t,k,p,m", SAMPLER_SETTINGS)
def test_sampler_rows_do_not_depend_on_the_batch(cuda, t, k, p, m):
    """136 rows of 32000 fp32 logits: each row's filtered logits and drawn
    token are the same bits alone, inside 17 rows and inside 136."""
    from painlessinferenceacceleration_tpu_torch.ops.sample import (
        filtered_logits,
        sample_tokens_at,
    )

    n, V = 136, 32000
    lg = torch.randn((n, V), generator=cuda, device="cuda") * 4
    arrs = (torch.full((n,), t, device="cuda"), torch.full((n,), k, device="cuda"),
            torch.full((n,), p, device="cuda"), torch.full((n,), m, device="cuda"))
    seeds = torch.arange(n, device="cuda") * 7 + 3
    pos = torch.arange(n, device="cuda") + 512
    x_all = filtered_logits(lg, *arrs)
    s_all = sample_tokens_at(lg, seeds, pos, *arrs)
    for lo, hi in ((0, 1), (5, 22), (119, 136), (70, 71)):
        part = (slice(lo, hi),)
        x = filtered_logits(lg[part], *(a[part] for a in arrs))
        s = sample_tokens_at(lg[part], seeds[part], pos[part], *(a[part] for a in arrs))
        assert torch.equal(x, x_all[lo:hi]) and torch.equal(s, s_all[lo:hi]), (lo, hi)
    kept = (x_all > -1e29).sum(1)
    assert (torch.gather(x_all, 1, s_all.long()[:, None]) > -1e29).all()
    if k:
        assert (kept <= k).all()


def test_sampled_lookahead_equals_sampled_ar_on_the_card(cuda):
    """A small bf16 llama: a sampled AR stream, then lookahead from a fresh
    prefill with the tables seeded with that stream (drafts land deep in
    the tree): the same tokens; and LLM serving of sampled requests gives
    the same streams under pingpong AR, pingpong lookahead and mix."""
    from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
    from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache
    from painlessinferenceacceleration_tpu_torch.engine.llm import LLM
    from painlessinferenceacceleration_tpu_torch.engine.multistep import (
        multistep_decode,
        multistep_spec_decode,
    )
    from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams
    from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step
    from painlessinferenceacceleration_tpu_torch.lookahead import device_tables as dt
    from painlessinferenceacceleration_tpu_torch.models.base import init_params
    from painlessinferenceacceleration_tpu_torch.ops.sample import sample_tokens_at

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    params = init_params(cfg, cuda, dtype=torch.bfloat16)
    ecfg = EngineConfig(page_size=64, max_seq_len=512, max_concurrency=1)
    prompt = torch.randint(10, 500, (1, 100), generator=cuda, device="cuda", dtype=torch.int32)
    pt = torch.arange(1, 1 + ecfg.pages_per_req, dtype=torch.int32, device="cuda")[None]
    ctx0 = torch.tensor([100], dtype=torch.int32, device="cuda")
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    samp = dict(temperature=torch.tensor([0.8], device="cuda"),
                top_k=torch.tensor([50], device="cuda"), top_p=torch.tensor([0.95], device="cuda"),
                min_p=torch.zeros(1, device="cuda"),
                seeds=torch.tensor([77], dtype=torch.int32, device="cuda"))

    def prefill():
        kv = init_kv_cache(cfg, ecfg)
        kv, _, logits = prefill_step(params, kv, cfg, prompt, torch.zeros_like(ctx0), ctx0, pt)
        first = sample_tokens_at(logits, samp["seeds"], ctx0, samp["temperature"],
                                 samp["top_k"], samp["top_p"], samp["min_p"])
        return kv, first

    kv, first = prefill()
    _, toks, *_ = multistep_decode(params, kv, cfg, first, ctx0, one, pt, n_steps=63, **samp)
    ar = [int(first[0])] + toks[0].tolist()
    kv, first2 = prefill()
    assert int(first2[0]) == ar[0]
    tcfg = dt.DraftTableConfig(buckets=1024, ways=4, branch_length=8, retrieve_count=2)
    tables = dt.init_draft_tables(tcfg)
    seq = prompt[0].tolist() + ar
    dt.update_tables_seq(tables, tcfg, torch.tensor(seq, dtype=torch.int32, device="cuda"),
                         len(seq))
    tail = torch.tensor([seq[100 - 9: 101]], dtype=torch.int32, device="cuda")
    out = multistep_spec_decode(params, kv, tables, cfg, tcfg, first2, ctx0, one, tail, pt,
                                n_steps=32, update_tables=False,
                                budget=torch.tensor([63], dtype=torch.int32, device="cuda"),
                                **samp)
    n_acc = out[3][0].tolist()
    stream = [ar[0]] + [x for s, n in enumerate(n_acc) for x in out[2][0, s, :n].tolist()]
    assert stream == ar
    assert max(n_acc) > 2

    prompts = [prompt[0].tolist()[:60], [5, 6, 7, 8] * 10, list(range(40, 90))]
    sps = [SamplingParams(max_new_tokens=24, temperature=0.8, top_k=50, seed=s) for s in (1, 2)]
    sps.append(SamplingParams(max_new_tokens=24))
    runs = []
    for kw in (dict(), dict(use_lookahead=True, decoding_length=16, branch_length=8,
                            use_spec_min_batch_size=4), dict(schedule_policy="mix")):
        llm = LLM(cfg=cfg, params=params, ecfg=EngineConfig(
            page_size=64, max_seq_len=512, max_concurrency=4, eos_token_id=-2, **kw))
        reqs = [llm.add_request(p, sp) for p, sp in zip(prompts, sps)]
        while any(r.state != "finished" for r in reqs):
            llm.step()
        runs.append([r.output_ids for r in reqs])
    assert runs[0] == runs[1] == runs[2]


def _slopes(Hq):
    from painlessinferenceacceleration_tpu_torch.ops.attention import alibi_slopes

    return alibi_slopes(Hq, "cuda")


@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
@pytest.mark.parametrize("arena", ["bf16", "fp8", "fp8_tok"])
@pytest.mark.parametrize("G", [1, 4])
def test_alibi_attention_in_every_arena_and_route(cuda, kind, arena, G):
    """ALiBi slopes through the kernel (bloom's 32-head slopes at G = 1)
    against the plain version with the same slopes and the step's key
    positions (a verify's at ctx + a depth in [0, Q), not their slots), and
    its launches counted apart from the slope-free ones."""
    Hkv = 32 if G == 1 else 4
    Hq = G * Hkv
    Q = {"decode": 1, "verify": 17, "prefill": 200}[kind]
    ctx_t, attend, plain = _any_arena(cuda, 2, [640, 77], Q, Hkv, arena)
    al = _slopes(Hq)
    q = torch.randn(2, Q, Hq, 128, generator=cuda, device="cuda").to(torch.bfloat16)
    qm = None if kind == "prefill" else _mask(cuda, 2, Q)
    pos = None  # prefill: the causal rule puts key s at ctx + s
    if kind != "prefill":
        step = torch.randint(0, Q, (2, Q), generator=cuda, device="cuda")
        pos = (ctx_t[:, None] + step).to(torch.int32).contiguous()
    wrapper = {"fp8_tok": paged_attention_tok, "prefill": paged_attention_prefill}.get(
        arena if arena == "fp8_tok" else kind, paged_attention)
    key = f"{kind},{arena},alibi"
    before = wrapper.modes[key]
    got = attend(q, qm, alibi=al, pos=pos)
    assert wrapper.modes[key] == before + 1
    ref_qm = causal_qmask(Q, "cuda")[None].expand(2, Q, Q) if qm is None else qm
    want = plain(q, ref_qm, alibi=al, pos=pos)
    assert _rel(got, want) < 2e-2
    # the slopes matter: the slope-free kernel gives other rows
    assert _rel(attend(q, qm), want) > 5e-2
    if kind == "verify":  # and the positions: biased by their slots, other rows
        assert _rel(attend(q, qm, alibi=al), want) > 5e-2
    if kind == "decode":  # its position is its slot: the same bits without it
        assert torch.equal(attend(q, qm, alibi=al), got)


@pytest.mark.parametrize("arena", ["bf16", "fp8", "fp8_tok"])
def test_alibi_tree_node_equals_its_ar_decode(cuda, arena):
    """A Q = 17 tree verify (two branches of 8) with ALiBi over 300 cached
    keys, its nodes at ctx + their depth: the row of branch 1's node l
    equals a Q = 1 decode of it over the AR layout, where the root and
    branch 1's nodes 0..l sit at slots ctx..ctx+1+l (rel 1e-2: the keys sit
    at other slots of the walk, so sums run in other orders). Biased by
    their slots, the rows differ."""
    from painlessinferenceacceleration_tpu_torch.lookahead.device_tables import (
        build_tree_inputs,
    )

    Hkv, R, L, ctx = 32, 2, 8, 300
    Q = 1 + R * L
    tok = arena == "fp8_tok"
    if arena == "bf16":
        k, v, pt, ctx_t = _arena(cuda, 1, [ctx], Q, Hkv)
        ks = vs = None
    else:
        k, v, ks, vs, pt, ctx_t = _fp8_arena(cuda, 1, [ctx], Q, Hkv, tok)
    branches = torch.randint(3, 1000, (1, R, L), generator=cuda, device="cuda")
    _, _, qm, depth = build_tree_inputs(torch.ones(1, dtype=torch.int32, device="cuda"),
                                        branches)
    pos = (ctx + depth).to(torch.int32).contiguous()
    al = _slopes(Hkv)
    q = torch.randn(1, Q, Hkv, 128, generator=cuda, device="cuda").to(torch.bfloat16)
    sc = 128 ** -0.5

    def run(q, kk, vv, kss, vss, m, c, p):
        if tok:
            return paged_attention_tok(q, kk, vv, kss, vss, pt, c, sc, m, al, p)
        return paged_attention(q, kk, vv, pt, c, m, sc, None if kss is None else (kss, vss),
                               al, p)

    tree = run(q, k, v, ks, vs, qm, ctx_t, pos)
    slot_rule = run(q, k, v, ks, vs, qm, ctx_t, None)
    # the AR layout: branch 1's rows moved over branch 0's
    k2, v2 = k.clone(), v.clone()
    moved = [k2, v2] + ([ks.clone(), vs.clone()] if tok else [])
    for i in range(L):
        src, dst = ctx + 1 + L + i, ctx + 1 + i
        for t in moved:
            t[int(pt[0, dst // 64]), dst % 64] = t[int(pt[0, src // 64]), src % 64]
    kss, vss = (moved[2], moved[3]) if tok else (ks, vs)
    one = torch.ones(1, 1, 1, dtype=torch.bool, device="cuda")
    for i in range(L):
        row = q[:, 1 + L + i: 2 + L + i].contiguous()
        ar = run(row, k2, v2, kss, vss, one, ctx_t + 1 + i, None)
        assert _rel(tree[:, 1 + L + i], ar[:, 0]) < 1e-2, i
        assert _rel(slot_rule[:, 1 + L + i], ar[:, 0]) > 5e-2, i


@pytest.mark.parametrize("arena", ["bf16", "fp8", "fp8_tok"])
def test_alibi_prefill_rows_equal_their_decodes(cuda, arena):
    """With ALiBi, row t of a causal prefill chunk (Q = 129 and 512 over 0
    and 333 cached keys) equals a Q = 1 decode of that token bit for bit."""
    Hkv = 32
    one = torch.ones(1, 1, 1, dtype=torch.bool, device="cuda")
    al = _slopes(Hkv)
    for Q in (129, 512):
        for ctx in (0, 333):
            ctx_t, attend, _ = _any_arena(cuda, 1, [ctx], Q, Hkv, arena)
            q = torch.randn(1, Q, Hkv, 128, generator=cuda, device="cuda").to(torch.bfloat16)
            pre = attend(q, None, alibi=al)
            for t in sorted({0, 1, 63, 64, 127, 128, Q // 2 + 5, Q - 1}):
                row = attend(q[:, t:t + 1].contiguous(), one, ctx_t + t, alibi=al,
                             pos=(ctx_t + t)[:, None].to(torch.int32))
                assert torch.equal(row[:, 0], pre[:, t]), (Q, ctx, t)


def test_alibi_later_branch_logits_equal_ar_on_the_card(cuda):
    """A bloom-shaped model in bf16 (4 heads of 128, 2 layers) on the card,
    in the bf16, fp8 and fp8_tok arenas: a tree verify of two branches of 8,
    a wrong draft on branch 0 and the AR continuation on branch 1 (its nodes
    at slots ctx + 9 + l, positions ctx + 1 + l). The root's and each
    branch-1 node's logits row carries the bits of the AR decode row at the
    same prefix (every op of a row is row-count invariant, the layer norm's
    sums included), and the same verify with its keys at their slots'
    positions does not."""
    from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
    from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache
    from painlessinferenceacceleration_tpu_torch.engine.step import (
        _verify_forward,
        decode_inputs,
        prefill_step,
    )
    from painlessinferenceacceleration_tpu_torch.lookahead.device_tables import (
        build_tree_inputs,
    )
    from painlessinferenceacceleration_tpu_torch.models.base import init_params

    cfg = ModelConfig.tiny_bloom(vocab_size=1024, hidden_size=512, intermediate_size=2048,
                                 num_hidden_layers=2)
    params = init_params(cfg, cuda, dtype=torch.bfloat16)
    L, n = 8, 200
    toks = torch.randint(3, 1024, (1, n), generator=cuda, device="cuda", dtype=torch.int32)
    ctx = torch.full((1,), n, dtype=torch.int32, device="cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    for kv_quant in ("none", "fp8", "fp8_tok"):
        ecfg = EngineConfig(page_size=64, max_seq_len=512, max_concurrency=1,
                            kv_quant=kv_quant)
        pt = torch.arange(1, 1 + ecfg.pages_per_req, dtype=torch.int32, device="cuda")[None]

        def prefill():
            kv = init_kv_cache(cfg, ecfg, dtype=torch.bfloat16, device="cuda")
            return prefill_step(params, kv, cfg, toks, zero, ctx, pt)

        kv, root, _ = prefill()
        rows, fed, last, c = [], [], root, ctx.clone()
        for _ in range(L + 1):
            t, p, qm, par = decode_inputs(last, c)
            kv, logits, _ = _verify_forward(params, kv, cfg, t, p, qm, par, pt, c, active,
                                            None, None)
            rows.append(logits[0, 0])
            last = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            fed.append(last)
            c = c + 1
        ar = torch.stack(fed[:L], dim=1)
        tokens, parents, qmask, depth = build_tree_inputs(
            root, torch.stack([(ar + 1) % 1024, ar], 1))

        def verify(positions):
            kv, _, _ = prefill()
            _, vl, _ = _verify_forward(params, kv, cfg, tokens, positions, qmask, parents, pt,
                                       ctx, active, None, None)
            return [vl[0, 0]] + [vl[0, 1 + L + i] for i in range(L)]

        got = verify(ctx[:, None] + depth)
        slots = verify(ctx[:, None] + torch.arange(1 + 2 * L, device="cuda",
                                                   dtype=torch.int32))
        bits = [bool(torch.equal(a, b)) for a, b in zip(got, rows)]
        assert all(bits), (kv_quant, bits, [_rel(a, b) for a, b in zip(got, rows)])
        assert not all(torch.equal(a, b) for a, b in zip(slots[1:], rows[1:])), kv_quant


def test_layer_norm_rows_are_row_count_invariant(cuda):
    """The layer norm of a row has the same bits at every row count (its
    sums are fixed-order halvings, where torch's CUDA mean picks its order
    by the shape)."""
    from painlessinferenceacceleration_tpu_torch.ops.rmsnorm import layer_norm

    for E in (4096, 4544, 512):
        x = (torch.randn(64, E, generator=cuda, device="cuda") * 3 + 0.5).to(torch.bfloat16)
        w = torch.randn(E, generator=cuda, device="cuda").to(torch.bfloat16)
        b = torch.randn(E, generator=cuda, device="cuda").to(torch.bfloat16)
        one = layer_norm(x[:1], w, b)
        for n in (2, 9, 17, 61, 64):
            assert torch.equal(layer_norm(x[:n], w, b)[:1], one), (E, n)


def test_slope_free_attention_build_keeps_its_registers(cuda):
    """ptxas's report: the slope-free kernels keep their registers
    (``SLOPE_FREE_REGISTERS``) and have no spills; the ALiBi ones have no
    spills either."""
    from painlessinferenceacceleration_tpu_torch.ops import paged_attention as pa

    seen = pa.ptxas_registers()
    assert len(seen) == 24, sorted(seen)  # 4 head-dim pairs x 3 arenas x ALiBi or not
    for (dk, dv, arena, alibi), r in seen.items():
        assert r["spills"] == 0, (dk, dv, arena, alibi)
        if not alibi and (dk, dv, arena) in pa.SLOPE_FREE_REGISTERS:
            assert r["registers"] == pa.SLOPE_FREE_REGISTERS[(dk, dv, arena)], (dk, arena, r)


def test_legacy_refusals_raise_when_the_engine_is_built(cuda):
    """What used to be refused when LLM was built now serves on the card:
    GPT-J's head dim 256 (K2 / K3 at (256, 256)), a tied head whose
    vocabulary is off the bf16 GEMM's N % 8 (GPT-2's 50257: the table is
    padded to a multiple of 8 rows and the logits cut back), AntGLM's
    prefix-LM prefill at Q > 128 (K3's window) and DeepSeek's expanded MLA
    (K2 / K3 at (192, 128)); each with lookahead equal to AR. A head dim
    off the kernel's pairs (112) still raises when LLM is built."""
    import dataclasses

    from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
    from painlessinferenceacceleration_tpu_torch.engine.llm import LLM
    from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams
    from painlessinferenceacceleration_tpu_torch.models.base import init_params

    ecfg = EngineConfig(page_size=64, max_seq_len=512, max_concurrency=2, eos_token_id=-2,
                        decoding_length=16, branch_length=4)
    gptj = ModelConfig(model_type="gptj", vocab_size=512, hidden_size=512,
                       intermediate_size=512, num_hidden_layers=1, num_attention_heads=2,
                       num_key_value_heads=2, norm_type="layernorm", gated_mlp=False,
                       hidden_act="gelu_new", parallel_residual=True, rope_interleaved=True,
                       partial_rotary_factor=0.25, mlp_bias=True)
    gpt2 = ModelConfig.tiny_gpt2(vocab_size=257, hidden_size=256, num_hidden_layers=1)
    glm = ModelConfig(model_type="glm", vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=1, num_attention_heads=4,
                      num_key_value_heads=4, position_embedding_type="glm_2d",
                      norm_type="layernorm", gated_mlp=False, hidden_act="gelu",
                      attention_bias=True, attention_out_bias=True, mlp_bias=True,
                      prefix_lm=True, tie_word_embeddings=True, mask_token_ids=(9,))
    mla = ModelConfig(model_type="deepseek_v2", vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=2, kv_lora_rank=64, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128, mla_latent_cache=False)
    prompts = [[(7 * i) % 500 + 10 for i in range(200)], [9] + [11, 12, 13] * 50]
    for cfg in (gptj, gpt2, glm, mla):
        params = init_params(cfg, cuda, dtype=torch.bfloat16)
        outs = []
        for la in (False, True):
            llm = LLM(cfg=cfg, params=params,
                      ecfg=dataclasses.replace(ecfg, use_lookahead=la, prefill_chunk=512))
            outs.append([r.output_ids for r in llm.generate(
                [[t % cfg.vocab_size for t in p] for p in prompts],
                SamplingParams(max_new_tokens=24))])
        assert outs[0] == outs[1], cfg.model_type
        assert all(0 <= t < cfg.vocab_size for o in outs[0] for t in o)
    bad = ModelConfig(model_type="gptj", vocab_size=512, hidden_size=224,
                      intermediate_size=224, num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=2, norm_type="layernorm", gated_mlp=False,
                      hidden_act="gelu_new", parallel_residual=True, rope_interleaved=True,
                      partial_rotary_factor=0.25, mlp_bias=True)  # head dim 112
    with pytest.raises(ValueError, match="head dims"):
        LLM(cfg=bad, params=init_params(bad, cuda, dtype=torch.bfloat16), ecfg=ecfg)


@pytest.mark.parametrize("family", ["llama", "bloom"])
def test_loaded_checkpoint_lookahead_equals_ar_on_the_card(cuda, tmp_path, family):
    """A checkpoint written with write_checkpoint (2 shards) and served by
    LLM(model_path=...) on the card (llama in int4, bloom in bf16 with
    ALiBi and its tied head): lookahead over 4 branches of 8 gives the AR
    outputs."""
    from painlessinferenceacceleration_tpu_torch.config import EngineConfig
    from painlessinferenceacceleration_tpu_torch.engine.llm import LLM
    from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams
    from painlessinferenceacceleration_tpu_torch.ops.paged_attention import (
        paged_attention as pa,
    )
    from painlessinferenceacceleration_tpu_torch.utils.safetensors import write_checkpoint

    g = torch.Generator().manual_seed(1)
    E, H, V, I, L = 512, 4, 1024, 1024, 2

    def w(*shape):
        return (torch.randn(*shape, generator=g) * 0.05).to(torch.bfloat16)

    if family == "llama":
        conf = dict(model_type="llama", vocab_size=V, hidden_size=E, intermediate_size=I,
                    num_hidden_layers=L, num_attention_heads=H, num_key_value_heads=H)
        sd = {"model.embed_tokens.weight": w(V, E), "model.norm.weight": 1 + w(E),
              "lm_head.weight": w(V, E)}
        for i in range(L):
            p = f"model.layers.{i}."
            sd.update({p + "input_layernorm.weight": 1 + w(E),
                       p + "post_attention_layernorm.weight": 1 + w(E),
                       p + "mlp.gate_proj.weight": w(I, E), p + "mlp.up_proj.weight": w(I, E),
                       p + "mlp.down_proj.weight": w(E, I)})
            for n in "qkvo":
                sd[p + f"self_attn.{n}_proj.weight"] = w(E, E)
        quant = "int4"
    else:
        conf = dict(model_type="bloom", vocab_size=V, hidden_size=E, n_layer=L, n_head=H)
        sd = {"transformer.word_embeddings.weight": w(V, E)}
        for n in ("transformer.word_embeddings_layernorm", "transformer.ln_f"):
            sd.update({n + ".weight": 1 + w(E), n + ".bias": w(E)})
        for i in range(L):
            p = f"transformer.h.{i}."
            for n, o, k in (("self_attention.query_key_value", 3 * E, E),
                            ("self_attention.dense", E, E), ("mlp.dense_h_to_4h", 4 * E, E),
                            ("mlp.dense_4h_to_h", E, 4 * E)):
                sd.update({p + n + ".weight": w(o, k), p + n + ".bias": w(o)})
            for n in ("input_layernorm", "post_attention_layernorm"):
                sd.update({p + n + ".weight": 1 + w(E), p + n + ".bias": w(E)})
        quant = "none"
    write_checkpoint(str(tmp_path), sd, conf, n_shards=2)
    prompts = [[5, 6, 7, 8] * 20, list(range(40, 140)), [9, 10, 11] * 7]
    outs = []
    for la in (False, True):
        ecfg = EngineConfig(page_size=64, max_seq_len=512, max_concurrency=4, eos_token_id=-2,
                            quant=quant, use_lookahead=la, decoding_length=32,
                            branch_length=8)
        llm = LLM(model_path=str(tmp_path), ecfg=ecfg)
        before = sum(v for k, v in pa.modes.items() if k.endswith("alibi"))
        outs.append([r.output_ids for r in llm.generate(prompts,
                                                        SamplingParams(max_new_tokens=48))])
        alibi = sum(v for k, v in pa.modes.items() if k.endswith("alibi")) - before
        assert (alibi > 0) == (family == "bloom")
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# IPAD (prune and distill) on the card
# ---------------------------------------------------------------------------

def _ipad_model(device, gen_seed=3):
    """A llama whose pruned shapes the card's kernels take (head dim 64;
    after mlp 0.5, head 0.5, depth 1/3 and dim 0.25: I 256, one kv group
    of 2 heads, 2 layers, E 192, a whole number of int4 groups of 64)."""
    from painlessinferenceacceleration_tpu_torch.config import ModelConfig
    from painlessinferenceacceleration_tpu_torch.models.base import init_params

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=512)
    params = init_params(cfg, torch.Generator().manual_seed(gen_seed), device="cpu")
    return cfg, {k: (v.to(device) if torch.is_tensor(v) else
                     {kk: vv.to(device) for kk, vv in v.items()}) for k, v in params.items()}


def _ipad_batches(seed, B=4, T=64):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(1, 511, size=(B, T)).astype(np.int32)


IPAD_STEP = dict(lr=1e-3, hidden_weight=0.5, target_mlp_sparsity=0.25, prune_steps=2,
                 total_steps=4)


def test_ipad_train_step_on_the_card_matches_the_cpu(cuda):
    """One train step on the card from a state the CPU reached in two
    steps, against the same step on the CPU: loss and CE within rel 1e-5,
    KL and the hidden MSE within rel 1e-3 (gaps between near-equal
    quantities), moments and saliency within rel 1e-4 of their leaf's
    largest value, the student within 1e-2 lr (fp32 on both, TF32 off;
    sums in other orders, which Adam's m / sqrt(v) amplifies at the few
    near-zero gradients)."""
    from painlessinferenceacceleration_tpu_torch.ipad import DistillConfig, Distiller
    from painlessinferenceacceleration_tpu_torch.ipad.optim import tree_leaves

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, tp = _ipad_model("cpu")
    host = Distiller(cfg, tp, DistillConfig(**IPAD_STEP))
    host.fit(_ipad_batches(1), steps=2)
    card = Distiller(cfg, {k: (v.cuda() if torch.is_tensor(v) else
                               {kk: vv.cuda() for kk, vv in v.items()})
                           for k, v in tp.items()}, DistillConfig(**IPAD_STEP))
    assert card.device.type == "cuda"
    card.set_state(host.student, host.opt_state.mu, host.opt_state.nu, host.opt_state.count,
                   host.masks, host._saliency, host.step_idx)
    toks = torch.as_tensor(next(_ipad_batches(2)))
    tl, th = host._teacher_logits(toks)
    want = host._train_step(toks, tl, th.float())
    got = card._train_step(toks.cuda(), tl.cuda(), th.float().cuda())
    for a, b, rel in zip(want[:4], got[:4], (1e-5, 1e-3, 1e-5, 1e-3)):
        assert abs(float(b) - float(a)) <= rel * abs(float(a)), (float(a), float(b))
    for trees, rel in (((host.opt_state.mu, card.opt_state.mu),
                        (host.opt_state.nu, card.opt_state.nu), (want[4], got[4])), 1e-4), \
            (((host.student, card.student),), None):
        for a_tree, b_tree in trees:
            for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
                err = float((a - b.cpu()).abs().max())
                tol = 1e-2 * IPAD_STEP["lr"] if rel is None else rel * float(a.abs().max())
                assert err <= tol, (err, tol)


def test_ipad_frozen_leaves_do_not_move_on_the_card(cuda):
    """A block finetune of layer 0: the embedding, the final norm, the LM
    head and layers 1-2 keep their bits over two steps; layer 0 moves."""
    from painlessinferenceacceleration_tpu_torch.ipad import DistillConfig, Distiller

    cfg, tp = _ipad_model("cuda")
    d = Distiller(cfg, tp, DistillConfig(lr=3e-3, target_mlp_sparsity=0.0))
    d.set_finetune("block", layer_indices=(0,))
    before = {k: (v.clone() if torch.is_tensor(v) else {kk: vv.clone() for kk, vv in v.items()})
              for k, v in d.student.items()}
    d.fit(_ipad_batches(3), steps=2)
    for k in ("embed", "final_ln", "lm_head"):
        assert torch.equal(before[k], d.student[k]), k
    for k, v in before["layers"].items():
        assert torch.equal(v[1:], d.student["layers"][k][1:]), k
        assert not torch.equal(v[0], d.student["layers"][k][0]), k


def test_ipad_resumes_bit_for_bit_on_the_card(cuda, tmp_path):
    """save / load, then the same two steps as the distiller saved: the
    student, the moments and the masks keep the same bits (every op of the
    step, the embedding backward included, is run-to-run deterministic on
    the card)."""
    from painlessinferenceacceleration_tpu_torch.ipad import DistillConfig, Distiller
    from painlessinferenceacceleration_tpu_torch.ipad.optim import tree_leaves

    cfg, tp = _ipad_model("cuda")
    d = Distiller(cfg, tp, DistillConfig(**IPAD_STEP))
    d.fit(_ipad_batches(5), steps=2)
    d.save(str(tmp_path / "d.pt"))
    d2 = Distiller(cfg, tp, DistillConfig(**IPAD_STEP))
    d2.load(str(tmp_path / "d.pt"))
    d.fit(_ipad_batches(7), steps=2)
    d2.fit(_ipad_batches(7), steps=2)
    for a_tree, b_tree in ((d.student, d2.student), (d.opt_state.mu, d2.opt_state.mu),
                           (d.opt_state.nu, d2.opt_state.nu), (d.masks, d2.masks)):
        for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
            assert torch.equal(a, b)
    assert d.history == d2.history


def test_ipad_pruned_model_lossless_on_the_card(cuda):
    """A DistillPipe over every mask kind on the card; the reparam'd model
    equals the masked student within 2e-4 (fp32), and cast to bf16 it serves
    through LLM in bf16 (K10) and in int4 group 64 (K1) with lookahead
    equal to AR."""
    from painlessinferenceacceleration_tpu_torch.config import EngineConfig
    from painlessinferenceacceleration_tpu_torch.engine.llm import LLM
    from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams
    from painlessinferenceacceleration_tpu_torch.ipad import DistillPipe, DistillStage
    from painlessinferenceacceleration_tpu_torch.ipad.train_forward import forward_logits
    from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec, quantize
    from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import dense_matmul
    from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import int4_matmul

    cfg, tp = _ipad_model("cuda")
    pipe = DistillPipe(cfg, tp, [
        DistillStage(mode="mlp", sparsity=0.5, steps=2, prune_steps=1, lr=1e-3),
        DistillStage(mode="head", sparsity=0.5, steps=2, prune_steps=1, lr=1e-3),
        DistillStage(mode="depth", sparsity=0.34, steps=2, prune_steps=1, lr=1e-3),
        DistillStage(mode="dim", sparsity=0.25, steps=2, prune_steps=1, lr=1e-3),
        DistillStage(mode="finetune", steps=2, lr=1e-3, finetune_mode="upper")])
    new_cfg, new_params, hist = pipe.run(_ipad_batches(9))
    assert len(hist) == 10
    assert (new_cfg.num_hidden_layers, new_cfg.num_key_value_heads,
            new_cfg.num_attention_heads, new_cfg.intermediate_size,
            new_cfg.hidden_size) == (2, 1, 2, 256, 192)
    d = pipe.distiller
    toks = torch.as_tensor(next(_ipad_batches(11)), device="cuda")
    with torch.no_grad():
        masked = forward_logits(d.student, cfg, toks, d.masks)
        sliced = forward_logits(new_params, new_cfg, toks)
    assert torch.allclose(sliced, masked, rtol=2e-4, atol=2e-4)
    p16 = {k: (v.to(torch.bfloat16) if torch.is_tensor(v) else
               {kk: vv.to(torch.bfloat16) for kk, vv in v.items()})
           for k, v in new_params.items()}
    spec = QuantSpec(bits=4, group=64)

    def q4(w):
        per = [quantize(w[li], spec) for li in range(w.shape[0])]
        return {k: torch.stack([p[k] for p in per]) for k in per[0]}

    p4 = dict(p16, layers=dict(p16["layers"]), lm_head=quantize(p16["lm_head"], spec))
    for k in ("wqkv", "wo", "wgu", "wdown"):
        p4["layers"][k] = q4(p16["layers"][k])
    prompts = [[5, 6, 7, 8] * 20, list(range(40, 140)), [9, 10, 11] * 7, [300, 301]]
    for quant, params, kernel in (("none", p16, dense_matmul), ("int4", p4, int4_matmul)):
        outs = []
        for la in (False, True):
            ecfg = EngineConfig(page_size=64, max_seq_len=512, max_concurrency=4,
                                eos_token_id=-2, quant=quant, quant_group=64,
                                use_lookahead=la, decoding_length=16, branch_length=8)
            before = kernel.launches
            llm = LLM(cfg=new_cfg, params=params, ecfg=ecfg)
            outs.append([r.output_ids for r in llm.generate(prompts,
                                                            SamplingParams(max_new_tokens=32))])
            assert kernel.launches > before, quant
        assert outs[0] == outs[1], quant
        assert all(len(o) == 32 for o in outs[0])


# ---------------------------------------------------------------------------
# context parallelism: K2 / K3 over a page range, with the rows' log-sum-exp
# ---------------------------------------------------------------------------


def _cp_case(g, Q, ctx, Hq=8, Hkv=2, n_pages=48):
    """Two requests over shuffled pages 1 .. n_pages - 1 of one bf16 arena,
    q and an ancestor-like mask (the causal rule where Q > 128)."""
    B, ps, D = 2, 64, 128
    P = -(-(max(ctx) + Q) // ps)
    k = torch.randn(n_pages, ps, Hkv * D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(n_pages, ps, Hkv * D, generator=g, device="cuda").to(torch.bfloat16)
    pt = (torch.randperm(n_pages - 1, generator=g, device="cuda")[: B * P] + 1).reshape(B, P)
    q = torch.randn(B, Q, Hq, D, generator=g, device="cuda").to(torch.bfloat16)
    qm = causal_qmask(Q, "cuda")[None].expand(B, Q, Q).contiguous()
    return q, k, v, pt.to(torch.int32), torch.tensor(ctx, dtype=torch.int32, device="cuda"), qm


def _cp_call(q, k, v, pt, ctx, qm, **kw):
    if q.shape[1] > 128:
        return paged_attention_prefill(q, k, v, pt, ctx, 128 ** -0.5, **kw)
    return paged_attention(q, k, v, pt, ctx, qm, 128 ** -0.5, **kw)


@pytest.mark.parametrize("Q,ctx", [(1, [700, 65]), (17, [1000, 3]), (300, [0, 129])])
def test_attention_page_range_and_lse_match_plain(cuda, Q, ctx):
    """K2 (Q <= 128) and K3 (Q > 128) with a page range and the log-sum-exp
    output against their plain twin: the output within rel 2e-2, the
    log-sum-exp within 2e-3 (natural log), rows that see no key in the
    range 0 and -inf in both."""
    q, k, v, pt, ctx_t, qm = _cp_case(cuda, Q, ctx)
    for rng in ((1, 24), (24, 48), (5, 6)):
        out, lse = _cp_call(q, k, v, pt, ctx_t, qm, page_range=rng, return_lse=True)
        ref, ref_lse = paged_attention_ref(q, k, v, pt, ctx_t, qm, 128 ** -0.5,
                                           page_range=rng, return_lse=True)
        empty = torch.isinf(ref_lse)
        assert torch.equal(torch.isinf(lse), empty), rng
        assert (out[empty[..., None].expand_as(out)] == 0).all(), rng
        fin = ~empty
        if fin.any():
            assert (lse[fin] - ref_lse[fin]).abs().max().item() < 2e-3, rng
            assert _rel(out, ref) < 2e-2, rng


@pytest.mark.parametrize("Q,ctx", [(1, [700, 65]), (17, [1000, 3]), (300, [0, 129])])
def test_attention_full_page_range_is_the_call_without_one(cuda, Q, ctx):
    """The range [0, n_pages) and the call without a range give the same
    bits, with the log-sum-exp asked for or not."""
    q, k, v, pt, ctx_t, qm = _cp_case(cuda, Q, ctx)
    plain = _cp_call(q, k, v, pt, ctx_t, qm)
    full, lse = _cp_call(q, k, v, pt, ctx_t, qm, page_range=(0, k.shape[0]),
                         return_lse=True)
    assert torch.equal(full, plain)
    assert torch.equal(_cp_call(q, k, v, pt, ctx_t, qm, return_lse=True)[0], plain)
    assert torch.isfinite(lse).all()


def test_ranged_attention_build_has_no_spills(cuda):
    """ptxas's report of the page-range instantiations (the bf16 arena
    without ALiBi, head dims 64 and 128): no spills."""
    from painlessinferenceacceleration_tpu_torch.ops import paged_attention as pa

    seen = pa.ptxas_registers(ranged=True)
    assert sorted(seen) == sorted((dk, dv, "bf16", False) for dk, dv in pa.HEAD_DIMS), \
        sorted(seen)
    assert all(r["spills"] == 0 for r in seen.values()), seen


def test_attention_empty_local_rows_are_zero_with_minus_inf(cuda):
    """A range that holds none of a request's pages: its rows come out 0
    with log-sum-exp -inf, never NaN."""
    q, k, v, pt, ctx_t, qm = _cp_case(cuda, 17, [500, 40])
    out, lse = paged_attention(q, k, v, pt, ctx_t, qm, 128 ** -0.5, page_range=(48, 60),
                               return_lse=True)
    assert (out == 0).all() and torch.isneginf(lse).all()


def test_cp_merge_of_page_ranges_matches_the_whole_call(cuda):
    """The plain merge of two ranks' partials (K2 / K3 over [lo, hi) of the
    pages each, rank order) within rel 2e-2 of the one-process call."""
    from painlessinferenceacceleration_tpu_torch.ops.cp_attention import merge_partials

    for Q, ctx in ((1, [700, 65]), (17, [1000, 3]), (300, [0, 129])):
        q, k, v, pt, ctx_t, qm = _cp_case(cuda, Q, ctx)
        parts = [_cp_call(q, k, v, pt, ctx_t, qm, page_range=r, return_lse=True)
                 for r in ((0, 24), (24, 48))]
        got = merge_partials(torch.stack([p[0] for p in parts]),
                             torch.stack([p[1] for p in parts]))
        assert _rel(got, _cp_call(q, k, v, pt, ctx_t, qm)) < 2e-2, (Q, ctx)


def test_two_rank_gloo_tp_step_on_one_card(cuda, tmp_path):
    """Two ranks share cuda:0 over gloo and serve a bf16 llama (head dim
    128) under tensor parallelism, lookahead on: every rank ends on the
    same tokens (DistLLM checks each step), and they are the tokens of
    the same ranks' AR run."""
    import dataclasses

    from _torch_dist import Ranks

    from painlessinferenceacceleration_tpu_torch.config import ModelConfig
    from painlessinferenceacceleration_tpu_torch.models.base import init_params

    cfg = ModelConfig.tiny(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
                           head_dim=128, intermediate_size=1024, vocab_size=1024)
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                         device="cpu")
    base = dict(page_size=64, max_seq_len=512, max_concurrency=4, eos_token_id=-2)
    prompts = [[11, 22, 33, 44, 55] * 6, [7, 8, 9] * 10]
    case = dict(world=2, cfg=dataclasses.asdict(cfg), params=params, mesh=(1, 2),
                prompts=prompts, max_new=24, device="cuda", dtype="bfloat16")
    cases = [dict(case, name="ar", ecfg=base),
             dict(case, name="la", ecfg=dict(base, use_lookahead=True, decoding_length=16,
                                             branch_length=8))]
    res = Ranks(2, cases, str(tmp_path), timeout=400).results()
    for r in res:
        assert r["ar"]["tokens"] == res[0]["ar"]["tokens"]
        assert r["la"]["tokens"] == r["ar"]["tokens"]


# ---------------------------------------------------------------------------
# paged attention at the head-dim pairs (GPT-J's 256, DeepSeek's expanded
# MLA 192 / 128), K3's prefix-LM window, and the e4m3 tied head
# ---------------------------------------------------------------------------

PAIRS = [(256, 256), (192, 128)]


def _pair_arena(g, B, ctx, Q, Hkv, dk, dv, arena):
    """(q maker, attend, plain, ctx_t, pt) over an arena of K rows of dk
    lanes and V rows of dv lanes a kv head, of the kind ``arena``."""
    ps = 64
    P = -(-(max(ctx) + Q) // ps) + 1
    n = B * P + 1
    pt = (torch.randperm(n - 1, generator=g, device="cuda")[: B * P] + 1).reshape(B, P)
    pt = pt.to(torch.int32)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    if arena == "bf16":
        k = torch.randn(n, ps, Hkv * dk, generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn(n, ps, Hkv * dv, generator=g, device="cuda").to(torch.bfloat16)
        ks = vs = None
    else:
        k, ks = _fp8(g, (n, ps, Hkv * dk), Hkv, arena == "fp8_tok")
        v, vs = _fp8(g, (n, ps, Hkv * dv), Hkv, arena == "fp8_tok")
    sc = dk ** -0.5

    def attend(q, qm, c=None, alibi=None, pos=None, window=None, page_range=None):
        c = ctx_t if c is None else c
        if arena == "fp8_tok":
            return paged_attention_tok(q, k, v, ks, vs, pt, c, sc, qm, alibi, pos, window)
        scales = None if ks is None else (ks, vs)
        if qm is None:
            return paged_attention_prefill(q, k, v, pt, c, sc, scales, alibi, page_range,
                                           window=window)
        return paged_attention(q, k, v, pt, c, qm, sc, scales, alibi, pos, page_range)

    def plain(q, qm, c=None, alibi=None, pos=None, page_range=None):
        c = ctx_t if c is None else c
        return paged_attention_ref(q, k, v, pt, c, qm, sc, ks, vs, alibi=alibi,
                                   alibi_pos=pos, page_range=page_range)
    attend.kv = (k, v)
    return attend, plain, ctx_t, pt


@pytest.mark.parametrize("dims", PAIRS, ids=["256x256", "192x128"])
@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
@pytest.mark.parametrize("arena", ["bf16", "fp8", "fp8_tok"])
@pytest.mark.parametrize("alibi", [False, True], ids=["slope_free", "alibi"])
def test_head_dim_pairs_in_every_arena_and_route(cuda, dims, kind, arena, alibi):
    """K2 / K3 / K5 at GPT-J's (256, 256) and DeepSeek's expanded (192, 128)
    head dims against the plain version, in every arena and route, with and
    without ALiBi; the output has V's lanes, and the launch counts under the
    pair."""
    dk, dv = dims
    Hq = Hkv = 4
    Q = {"decode": 1, "verify": 17, "prefill": 200}[kind]
    attend, plain, ctx_t, _ = _pair_arena(cuda, 2, [640, 77], Q, Hkv, dk, dv, arena)
    q = torch.randn(2, Q, Hq, dk, generator=cuda, device="cuda").to(torch.bfloat16)
    qm = None if kind == "prefill" else _mask(cuda, 2, Q)
    al = _slopes(Hq) if alibi else None
    pos = None
    if alibi and kind == "verify":
        step = torch.randint(0, Q, (2, Q), generator=cuda, device="cuda")
        pos = (ctx_t[:, None] + step).to(torch.int32).contiguous()
    wrapper = {"fp8_tok": paged_attention_tok, "prefill": paged_attention_prefill}.get(
        arena if arena == "fp8_tok" else kind, paged_attention)
    before = wrapper.dims[f"{dk}x{dv},{kind},{arena}"]
    got = attend(q, qm, alibi=al, pos=pos)
    assert wrapper.dims[f"{dk}x{dv},{kind},{arena}"] == before + 1
    assert got.shape == (2, Q, Hq, dv)
    ref_qm = causal_qmask(Q, "cuda")[None].expand(2, Q, Q) if qm is None else qm
    assert _rel(got, plain(q, ref_qm, alibi=al, pos=pos)) < 2e-2


@pytest.mark.parametrize("dims", PAIRS, ids=["256x256", "192x128"])
@pytest.mark.parametrize("kind", ["verify", "prefill"])
def test_head_dim_pairs_over_a_page_range(cuda, dims, kind):
    """The RANGED build at the new pairs: a page range's rows and
    log-sum-exp against the plain twin, and the full range equal to the call
    without one, bit for bit."""
    dk, dv = dims
    Q = 17 if kind == "verify" else 200
    attend, plain, ctx_t, pt = _pair_arena(cuda, 2, [640, 77], Q, 2, dk, dv, "bf16")
    q = torch.randn(2, Q, 4, dk, generator=cuda, device="cuda").to(torch.bfloat16)
    qm = None if kind == "prefill" else _mask(cuda, 2, Q)
    ref_qm = causal_qmask(Q, "cuda")[None].expand(2, Q, Q) if qm is None else qm
    lo = int(pt.min()) + 3
    rng = (lo, lo + pt.numel() // 2)
    k, v = attend.kv
    if qm is None:
        got, lse = paged_attention_prefill(q, k, v, pt, ctx_t, dk ** -0.5,
                                           page_range=rng, return_lse=True)
    else:
        got, lse = paged_attention(q, k, v, pt, ctx_t, qm, dk ** -0.5,
                                   page_range=rng, return_lse=True)
    want, want_lse = paged_attention_ref(q, k, v, pt, ctx_t, ref_qm, dk ** -0.5,
                                         page_range=rng, return_lse=True)
    assert _rel(got, want) < 2e-2
    seen = torch.isfinite(want_lse)
    assert torch.equal(seen, torch.isfinite(lse))
    assert (lse[seen] - want_lse[seen]).abs().max().item() < 1e-2
    full = attend(q, qm, page_range=(0, 2 ** 31 - 2))
    assert torch.equal(full, attend(q, qm))


@pytest.mark.parametrize("dims", PAIRS, ids=["256x256", "192x128"])
@pytest.mark.parametrize("arena", ["bf16", "fp8", "fp8_tok"])
def test_head_dim_prefill_rows_equal_their_decodes(cuda, dims, arena):
    """A causal prefill row at (256, 256) and (192, 128) is bit-equal to the
    decode of its token over the same keys (the rule lookahead == AR rests
    on), in every arena; so is row 0 of a verify window."""
    dk, dv = dims
    Q = 150
    attend, _, ctx_t, _ = _pair_arena(cuda, 2, [300, 66], Q, 4, dk, dv, arena)
    q = torch.randn(2, Q, 4, dk, generator=cuda, device="cuda").to(torch.bfloat16)
    pre = attend(q, None)
    one = torch.ones(2, 1, 1, dtype=torch.bool, device="cuda")
    for t in (0, 63, 64, 149):
        row = attend(q[:, t:t + 1].contiguous(), one, ctx_t + t)
        assert torch.equal(pre[:, t:t + 1], row), (dims, arena, t)


@pytest.mark.parametrize("arena", ["bf16", "fp8", "fp8_tok"])
@pytest.mark.parametrize("ctx", [[0, 0], [70, 130]])
def test_prefix_window_prefill(cuda, arena, ctx):
    """K3's prefix-LM window against the plain version with JAX's mask (key
    s visible to row t iff s <= t or ctx + s < window[b]) at a 512-row
    chunk; a window inside the committed keys gives the causal call's bits;
    the launch counts under ",window"."""
    from painlessinferenceacceleration_tpu_torch.ops.paged_attention import window_qmask

    Q, H = 512, 4
    attend, plain, ctx_t, _ = _pair_arena(cuda, 2, ctx, Q, H, 64, 64, arena)
    q = torch.randn(2, Q, H, 64, generator=cuda, device="cuda").to(torch.bfloat16)
    wrapper = paged_attention_tok if arena == "fp8_tok" else paged_attention_prefill
    for win in ([300 + ctx[0], 40 + ctx[1]], [ctx[0] + 600, ctx[1] + 129]):
        w = torch.tensor(win, dtype=torch.int32, device="cuda")
        before = wrapper.modes[f"prefill,{arena},window"]
        got = attend(q, None, window=w)
        assert wrapper.modes[f"prefill,{arena},window"] == before + 1
        want = plain(q, window_qmask(2, Q, ctx_t, w, "cuda"))
        assert _rel(got, want) < 2e-2, win
    inside = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    assert torch.equal(attend(q, None, window=inside), attend(q, None))


@pytest.mark.parametrize("M", [1, 17, 70, 512])
@pytest.mark.parametrize("V,E", [(50264, 1600), (4099, 4096), (250880, 4096)])
def test_fp8_tied_head(cuda, M, V, E):
    """The e4m3 tied head's kernel against its plain version (fp32 sums of
    exact products in another order: 1e-4 relative), any vocabulary (4099
    is off every multiple), and a row alone bit-equal to itself inside M
    rows."""
    from painlessinferenceacceleration_tpu_torch.layers.embedding import make_embedding
    from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
        fp8_head_matmul,
        fp8_head_matmul_plain,
    )

    if V == 250880 and M > 17:
        pytest.skip("BLOOM's table at decode and verify widths only (1 GB of e4m3)")
    table = torch.randn(V, E, generator=cuda, device="cuda") * 0.02
    emb = make_embedding(table, QuantSpec.from_mode("w8a8_fp8"))
    h = torch.randn(M, E, generator=cuda, device="cuda").to(torch.bfloat16)
    before = fp8_head_matmul.launches
    got = fp8_head_matmul(h, emb["q"], emb["s"])
    assert fp8_head_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, V)
    assert _rel(got, fp8_head_matmul_plain(h, emb["q"], emb["s"])) < 1e-4
    assert torch.equal(fp8_head_matmul(h[:1].contiguous(), emb["q"], emb["s"]), got[:1])


def test_fp8_head_build_has_no_spills(cuda):
    """ptxas's report of the e4m3 head kernel: no spills."""
    import re

    from painlessinferenceacceleration_tpu_torch import _build

    _build.library("fp8_head_gemm")
    report = _build.ptxas_report("fp8_head_gemm")
    assert "fp8_head_kernel" in report
    for m in re.finditer(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report):
        assert m.group(1) == "0" and m.group(2) == "0", report


def test_fp8_tied_head_serves_with_lookahead_equal_to_ar(cuda):
    """BLOOM-like tied head under ``quant_embed`` (e4m3 table) and GPT-2's
    off-grid vocabulary (257, padded to 264) on the card: the e4m3 head
    kernel serves, lookahead equals AR."""
    import dataclasses

    from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
    from painlessinferenceacceleration_tpu_torch.engine.llm import LLM
    from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams
    from painlessinferenceacceleration_tpu_torch.models.base import init_params
    from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import fp8_head_matmul

    cfg = ModelConfig.tiny_gpt2(vocab_size=257, hidden_size=256, num_hidden_layers=2)
    params = init_params(cfg, cuda, dtype=torch.bfloat16)
    ecfg = EngineConfig(page_size=64, max_seq_len=256, max_concurrency=2, eos_token_id=-2,
                        quant_embed=True, decoding_length=16, branch_length=4)
    outs = []
    before = fp8_head_matmul.launches
    for la in (False, True):
        llm = LLM(cfg=cfg, params=params, ecfg=dataclasses.replace(ecfg, use_lookahead=la))
        outs.append([r.output_ids for r in llm.generate(
            [[5, 6, 7] * 10, [200, 3, 256] * 5], SamplingParams(max_new_tokens=24))])
    assert fp8_head_matmul.launches > before
    assert outs[0] == outs[1]
    assert all(0 <= t < 257 for o in outs[0] for t in o)


# ---------------------------------------------------------------------------
# the geometries of Qwen2 / Qwen2.5 / Qwen3 (5, 6 and 7 query heads a kv
# head), OPT's and BLOOM's heads of 80 and 96 lanes (the 128-lane build at
# the heads' own widths), tree verify past 128 rows, and the TP-mode W8A8
# experts' whole-row amax
# ---------------------------------------------------------------------------

# (G, head dim, ALiBi): the name of each geometry
GEOMETRIES = {"G5": (5, 128, False), "G6": (6, 128, False), "G7": (7, 128, False),
              "D80": (1, 80, False), "D80_alibi": (4, 80, True), "D96": (2, 96, False),
              "D96_alibi": (1, 96, True)}
GEOMETRY_KINDS = {"decode": 1, "verify": 17, "verify129": 129, "prefill": 512}


@pytest.mark.parametrize("geom", list(GEOMETRIES))
@pytest.mark.parametrize("kind", list(GEOMETRY_KINDS))
@pytest.mark.parametrize("arena", ["bf16", "fp8", "fp8_tok"])
def test_new_geometries_in_every_arena_and_route(cuda, geom, kind, arena):
    """K2 / K3 / K5 against the plain version at G = 5, 6, 7 (a tile's last
    128 - G * (128 // G) rows padding) and at heads of 80 and 96 lanes
    (the next head's lanes read beside a head's own, TMA's zeros past the
    last), with and without ALiBi, two kv heads, ragged contexts: decode,
    a 17-row and a 129-row tree verify (the mask rule over two tiles and
    more), a 512-row prefill. The launch counts under the head dims and
    the group."""
    G, D, alibi = GEOMETRIES[geom]
    Q = GEOMETRY_KINDS[kind]
    rule = "prefill" if kind == "prefill" else "decode" if Q == 1 else "verify"
    Hkv = 2
    Hq = G * Hkv
    attend, plain, ctx_t, _ = _pair_arena(cuda, 2, [640, 77], Q, Hkv, D, D, arena)
    q = torch.randn(2, Q, Hq, D, generator=cuda, device="cuda").to(torch.bfloat16)
    qm = None if rule == "prefill" else _mask(cuda, 2, Q)
    al = _slopes(Hq) if alibi else None
    pos = None
    if alibi and rule == "verify":
        step = torch.randint(0, Q, (2, Q), generator=cuda, device="cuda")
        pos = (ctx_t[:, None] + step).to(torch.int32).contiguous()
    wrapper = paged_attention_tok if arena == "fp8_tok" else (
        paged_attention_prefill if rule == "prefill" else paged_attention)
    dims = f"{D}x{D},{rule},{arena}"
    before = (wrapper.dims[dims], wrapper.groups[f"{G},{rule},{arena}"])
    got = attend(q, qm, alibi=al, pos=pos)
    assert (wrapper.dims[dims], wrapper.groups[f"{G},{rule},{arena}"]) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (2, Q, Hq, D)
    ref_qm = causal_qmask(Q, "cuda")[None].expand(2, Q, Q) if qm is None else qm
    assert _rel(got, plain(q, ref_qm, alibi=al, pos=pos)) < 2e-2


@pytest.mark.parametrize("G,D", [(7, 128), (1, 80), (2, 96)])
@pytest.mark.parametrize("arena", ["bf16", "fp8", "fp8_tok"])
def test_new_geometries_prefill_rows_equal_their_decodes(cuda, G, D, arena):
    """A causal prefill row (Q = 300, at every place of the first tile and
    at the last rows) is bit-equal to the Q = 1 decode of its token, and
    the rows of a 129-row verify whose mask is causal to the prefill's: at
    G = 7 (126 rows of a tile) and at heads of 80 and 96 lanes."""
    Q, Hkv = 300, 2
    attend, _, ctx_t, _ = _pair_arena(cuda, 1, [45], Q, Hkv, D, D, arena)
    q = torch.randn(1, Q, G * Hkv, D, generator=cuda, device="cuda").to(torch.bfloat16)
    pre = attend(q, None)
    one = torch.ones(1, 1, 1, dtype=torch.bool, device="cuda")
    for t in list(range(128 // G)) + list(range(Q - 5, Q)):
        row = attend(q[:, t:t + 1].contiguous(), one, ctx_t + t)
        assert torch.equal(pre[:, t:t + 1], row), (G, D, arena, t)
    t0 = 150
    ver = attend(q[:, t0:t0 + 129].contiguous(), causal_qmask(129, "cuda")[None],
                 ctx_t + t0)
    assert torch.equal(ver, pre[:, t0:t0 + 129])


@pytest.mark.parametrize("G,D", [(7, 128), (1, 80), (2, 96), (4, 128)])
@pytest.mark.parametrize("Q,causal", [(17, False), (129, False), (300, True)])
def test_cp_partial_over_a_page_range_at_the_new_geometries(cuda, G, D, Q, causal):
    """A context-parallel rank's call (``cp_partial``: K2 under a tree mask
    at any width, a 129-row verify over several tiles, K3 for a causal
    chunk past 128 rows) with a page range and the log-sum-exp at G = 7,
    at heads of 80 and 96 lanes and at G = 4: rows within rel 2e-2 and
    log-sum-exp within 2e-3 of the plain twin, rows that see no key in the
    range 0 with -inf (a range past every page: all of them); and the
    range of every page gives the bits of the call without one."""
    from painlessinferenceacceleration_tpu_torch.ops.cp_attention import cp_partial

    Hkv = 2
    attend, _, ctx_t, pt = _pair_arena(cuda, 2, [640, 77], Q, Hkv, D, D, "bf16")
    k, v = attend.kv
    q = torch.randn(2, Q, G * Hkv, D, generator=cuda, device="cuda").to(torch.bfloat16)
    qm = (causal_qmask(Q, "cuda")[None].expand(2, Q, Q).contiguous() if causal
          else _mask(cuda, 2, Q))
    sc = D ** -0.5
    lo, end = int(pt.min()) + 3, k.shape[0]
    for rng in ((lo, lo + pt.numel() // 2), (end, end + 4)):
        out, lse = cp_partial(q, k, v, pt, ctx_t, qm, sc, causal, rng)
        ref, ref_lse = paged_attention_ref(q, k, v, pt, ctx_t, qm, sc, page_range=rng,
                                           return_lse=True)
        empty = torch.isinf(ref_lse)
        assert torch.equal(torch.isinf(lse), empty), rng
        assert (out[empty[..., None].expand_as(out)] == 0).all(), rng
        fin = ~empty
        if fin.any():
            assert (lse[fin] - ref_lse[fin]).abs().max().item() < 2e-3, rng
            assert _rel(out, ref) < 2e-2, rng
    full, _ = cp_partial(q, k, v, pt, ctx_t, qm, sc, causal, (0, end))
    assert torch.equal(full, attend(q, None if causal else qm))


@pytest.mark.parametrize("Q", [9, 10, 18, 19, 36, 37])
@pytest.mark.parametrize("arena", ["bf16", "fp8_tok"])
def test_attention_at_tile_edges_of_seven_heads(cuda, Q, arena):
    """G = 7: Q * G at the edges of the 126-row tile (63 / 70 rows: one
    warpgroup's rows or two; 126 / 133: one tile full, or a second tile of
    one position; 252 / 259), by the mask rule and the causal rule, against
    the plain version."""
    Hkv = 4
    attend, plain, ctx_t, _ = _pair_arena(cuda, 2, [70, 333], Q, Hkv, 128, 128, arena)
    q = torch.randn(2, Q, 7 * Hkv, 128, generator=cuda, device="cuda").to(torch.bfloat16)
    qm = _mask(cuda, 2, Q)
    assert _rel(attend(q, qm), plain(q, qm)) < 2e-2
    cq = causal_qmask(Q, "cuda")[None].expand(2, Q, Q)
    assert _rel(attend(q, None), plain(q, cq)) < 2e-2


def test_tp_moe_w8a8_experts_quantize_with_the_whole_row_amax(cuda, tmp_path):
    """Two ranks share cuda:0 over gloo and serve a Mixtral-shaped MoE (bf16,
    dynamic W8A8 int8 experts) under tensor parallelism: each rank's int8
    activations and per-token scales of layer 0's expert down products,
    taken from the serving path, equal, bit for bit, the rank's columns of
    one process's (an intermediate width of 384, 192 a rank, so that the
    down products' rows are told apart from the hidden width's 256), and
    both ranks end on the same tokens, lookahead equal to AR."""
    import dataclasses

    from _torch_dist import Ranks

    from painlessinferenceacceleration_tpu_torch.config import ModelConfig
    from painlessinferenceacceleration_tpu_torch.models.base import init_params

    cfg = ModelConfig(model_type="mixtral", vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=64, num_experts=8,
                      num_experts_per_tok=2, moe_intermediate_size=384, moe_layer_start=0)
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                         device="cpu", quant=QuantSpec.from_mode("w8a8_int8"))
    base = dict(page_size=64, max_seq_len=512, max_concurrency=2, eos_token_id=-2,
                quant="w8a8_int8")
    case = dict(world=2, cfg=dataclasses.asdict(cfg), params=params, mesh=(1, 2),
                prompts=[[11, 22, 33, 44, 55] * 6, [7, 8, 9] * 10], max_new=16,
                device="cuda", dtype="bfloat16")
    cases = [dict(case, name="ar", ecfg=base, tp_quant=True),
             dict(case, name="la", ecfg=dict(base, use_lookahead=True, decoding_length=16,
                                             branch_length=8))]
    res = Ranks(2, cases, str(tmp_path), timeout=400).results()
    for r in res:
        assert r["ar"]["tp_quant_equal"] is True
        assert r["ar"]["tokens"] == res[0]["ar"]["tokens"]
        assert r["la"]["tokens"] == r["ar"]["tokens"]
