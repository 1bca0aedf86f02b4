"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
where there is none (the CPU test run). Run them on a machine with a card:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

(``--noconftest``: the tests directory's conftest imports JAX, which a
machine for the port need not have.)

Tolerances: bf16 outputs within 2e-2 relative to the plain fp32-accumulated
version; fp32 outputs within 1e-4; the KV permute bit for bit.
"""

import pytest
import torch

from painlessinferenceacceleration_tpu_torch.ops.attention import (
    causal_qmask,
    paged_attention_ref,
)
from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
    kv_permute_pages,
    kv_permute_pages_plain,
)
from painlessinferenceacceleration_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_prefill,
)
from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
    int4_matmul,
    int4_matmul_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.parametrize("M,K,N", [(1, 4096, 4096), (17, 11008, 512), (70, 256, 384)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_int4_gemm(cuda, M, K, N, out):
    x = torch.randn(M, K, generator=cuda, device="cuda").to(torch.bfloat16)
    q = torch.randint(0, 256, (K // 2, N), generator=cuda, device="cuda", dtype=torch.uint8)
    s = (torch.rand(K // 128, N, generator=cuda, device="cuda") * 0.01).to(torch.bfloat16)
    before = int4_matmul.launches
    got = int4_matmul(x, q, s, out)
    assert int4_matmul.launches == before + 1
    tol = 2e-2 if out == torch.bfloat16 else 1e-4
    assert _rel(got, int4_matmul_plain(x, q, s, out)) < tol


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
