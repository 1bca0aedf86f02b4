"""Loading HF checkpoints in the port against the JAX package, on the CPU.

- ``read_safetensors`` against the ``safetensors`` package, byte for byte,
  in every dtype the reader takes, from one file and from a sharded
  directory with its index; ``write_safetensors`` read back by the package.
- ``ModelConfig.from_hf`` against the JAX ``ModelConfig.from_hf`` on a
  config dict for every branch: every field equal.
- ``params_from_state_dict`` against the JAX loader on the same
  self-written state dict for every key scheme: the port's tree equals
  ``params_from_jax`` of JAX's leaf for leaf, byte for byte, native (bf16),
  int4 and int8 leaves and DeepSeek-V3's pre-quantized fp8 blocks.
- ``LLM(model_path=...)`` against the JAX ``LLM(model_path=...)`` on one
  self-written checkpoint (fp32): the greedy tokens of text prompts equal.

Nothing is downloaded: every checkpoint is written by the test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu import config as jcfg_mod
from painlessinferenceacceleration_tpu.layers.linear import QuantSpec as JQuantSpec
from painlessinferenceacceleration_tpu.models import hf_loader as jhf

from painlessinferenceacceleration_tpu_torch import config as tcfg_mod
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec as TQuantSpec
from painlessinferenceacceleration_tpu_torch.models import hf_loader as thf
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax
from painlessinferenceacceleration_tpu_torch.utils import safetensors as st


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (many small ops; a thread
    pool per op beside the parallel run's other workers mostly waits)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the safetensors reader and writer
# ---------------------------------------------------------------------------

def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _tensors(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, dt in st.DTYPES.items():
        x = torch.randn(3, 7, generator=g) * 20
        out[f"w.{name}"] = x > 0 if dt == torch.bool else x.to(dt)
    out["odd.I8"] = torch.arange(5, dtype=torch.int8)  # leaves the next one misaligned
    out["scalar.F32"] = torch.tensor(2.5)
    out["empty.BF16"] = torch.zeros(0, 4, dtype=torch.bfloat16)
    return out


@pytest.mark.parametrize("dtype", sorted(st.DTYPES))
@pytest.mark.parametrize("sharded", [False, True], ids=["file", "sharded"])
def test_read_safetensors_matches_the_package(tmp_path, dtype, sharded):
    stp = pytest.importorskip("safetensors.torch")
    ts = _tensors(3)
    if sharded:  # the package writes each shard; the index maps names to them
        import json
        keys = list(ts)
        shards = {"a.safetensors": keys[::2], "b.safetensors": keys[1::2]}
        for fn, ks in shards.items():
            stp.save_file({k: ts[k] for k in ks}, str(tmp_path / fn))
        (tmp_path / st.INDEX).write_text(json.dumps(
            {"weight_map": {k: fn for fn, ks in shards.items() for k in ks}}))
        got = st.read_safetensors(str(tmp_path))
    else:
        stp.save_file(ts, str(tmp_path / "m.safetensors"))
        got = st.read_safetensors(str(tmp_path / "m.safetensors"))
    assert set(got) == set(ts)
    for k in (f"w.{dtype}", "odd.I8", "scalar.F32", "empty.BF16"):
        assert got[k].dtype == ts[k].dtype and got[k].shape == ts[k].shape, k
        assert _bytes(got[k]) == _bytes(ts[k]), k


@pytest.mark.parametrize("n_shards", [1, 3])
def test_write_checkpoint_reads_back_in_the_package(tmp_path, n_shards):
    stp = pytest.importorskip("safetensors.torch")
    ts = _tensors(4)
    st.write_checkpoint(str(tmp_path), ts, {"model_type": "llama"}, n_shards=n_shards)
    files = sorted(p.name for p in tmp_path.glob("*.safetensors"))
    assert len(files) == n_shards and (tmp_path / "config.json").exists()
    assert (tmp_path / st.INDEX).exists() == (n_shards > 1)
    seen = {}
    for fn in files:
        seen.update(stp.load_file(str(tmp_path / fn)))
    assert set(seen) == set(ts)
    for k in ts:
        assert seen[k].dtype == ts[k].dtype and _bytes(seen[k]) == _bytes(ts[k]), k
    mine = st.read_safetensors(str(tmp_path))
    assert all(_bytes(mine[k]) == _bytes(ts[k]) for k in ts)


# ---------------------------------------------------------------------------
# ModelConfig.from_hf
# ---------------------------------------------------------------------------

HF_CONFIGS = {
    "llama": dict(model_type="llama", vocab_size=32000, hidden_size=4096,
                  intermediate_size=11008, num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=32, rms_norm_eps=1e-5, max_position_embeddings=4096,
                  rope_scaling={"rope_type": "llama3", "factor": 8.0}),
    "mistral": dict(model_type="mistral", hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                    head_dim=None, rope_theta=1e6),
    "qwen2": dict(model_type="qwen2", hidden_size=896, intermediate_size=4864,
                  num_attention_heads=14, num_key_value_heads=2, attention_bias=True,
                  tie_word_embeddings=True),
    "qwen3": dict(model_type="qwen3", hidden_size=1024, head_dim=128,
                  num_attention_heads=16, num_key_value_heads=8),
    "qwen3_moe": dict(model_type="qwen3_moe", hidden_size=2048, num_experts=128,
                      num_experts_per_tok=8, moe_intermediate_size=768, head_dim=128),
    "mixtral": dict(model_type="mixtral", num_local_experts=8, num_experts_per_tok=2,
                    intermediate_size=14336, num_key_value_heads=8),
    "deepseek_v2": dict(model_type="deepseek_v2", hidden_size=2048, num_attention_heads=16,
                        kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128,
                        qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=64,
                        n_shared_experts=2, first_k_dense_replace=1, num_experts_per_tok=6,
                        moe_intermediate_size=1408),
    "deepseek_v3": dict(model_type="deepseek_v3", hidden_size=7168, num_attention_heads=128,
                        kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                        qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=256,
                        n_shared_experts=1, first_k_dense_replace=3, n_group=8,
                        topk_group=4, routed_scaling_factor=2.5, num_experts_per_tok=8,
                        quantization_config={"quant_method": "fp8",
                                             "weight_block_size": [128, 128]}),
    "internlm": dict(model_type="internlm", hidden_size=4096, num_attention_heads=32,
                     bias=True),
    "baichuan_7b": dict(model_type="baichuan", hidden_size=4096, num_attention_heads=32,
                        vocab_size=64000),
    "baichuan_13b": dict(model_type="baichuan", hidden_size=5120, num_attention_heads=40,
                         vocab_size=125696, intermediate_size=13696),
    "qwen": dict(model_type="qwen", hidden_size=4096, num_attention_heads=32,
                 intermediate_size=22016, layer_norm_epsilon=1e-6, rotary_emb_base=10000,
                 vocab_size=151936),
    "bailing_moe_linear_v2": dict(model_type="bailing_moe_linear_v2", hidden_size=2048,
                                  num_attention_heads=16, num_key_value_heads=4,
                                  layer_group_size=5, use_qk_norm=True, num_experts=256,
                                  num_shared_experts=1, first_k_dense_replace=1,
                                  moe_intermediate_size=512, n_group=8, topk_group=4,
                                  num_experts_per_tok=8, routed_scaling_factor=2.5),
    "opt": dict(model_type="opt", hidden_size=768, ffn_dim=3072, num_hidden_layers=12,
                num_attention_heads=12, activation_function="relu", vocab_size=50272,
                max_position_embeddings=2048),
    "gptj": dict(model_type="gptj", n_embd=4096, n_layer=28, n_head=16, rotary_dim=64,
                 n_positions=2048, vocab_size=50400, activation_function="gelu_new"),
    "gpt2": dict(model_type="gpt2", n_embd=768, n_layer=12, n_head=12, n_positions=1024,
                 vocab_size=50257, activation_function="gelu_new"),
    "bloom": dict(model_type="bloom", hidden_size=4096, n_layer=30, n_head=32,
                  vocab_size=250880, layer_norm_epsilon=1e-5),
    "glm": dict(model_type="glm", hidden_size=4096, num_layers=48, num_attention_heads=64,
                vocab_size=50048, max_sequence_length=1024, block_position_encoding=True,
                mask_token_ids=[50003, 50008, 50009]),
    "chatglm": dict(model_type="chatglm", hidden_size=4096, num_layers=28,
                    num_attention_heads=32, multi_query_group_num=2, ffn_hidden_size=13696,
                    padded_vocab_size=65024, seq_length=32768, rope_ratio=1.0,
                    add_qkv_bias=True, layernorm_epsilon=1e-5),
}


@pytest.mark.parametrize("family", list(HF_CONFIGS))
def test_from_hf_matches_jax(family):
    import dataclasses

    conf = HF_CONFIGS[family]
    j = jcfg_mod.ModelConfig.from_hf(dict(conf))
    t = tcfg_mod.ModelConfig.from_hf(dict(conf))
    shared = {f.name for f in dataclasses.fields(t)} & {f.name for f in dataclasses.fields(j)}
    assert len(shared) == len(dataclasses.fields(t))
    for name in sorted(shared):
        assert getattr(t, name) == getattr(j, name), name
    assert not t.mla_latent_cache  # an MLA checkpoint comes up in expanded mode


def test_from_hf_reads_a_model_directory(tmp_path):
    import json

    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS["bloom"]))
    assert tcfg_mod.ModelConfig.from_hf(str(tmp_path)) == tcfg_mod.ModelConfig.from_hf(
        HF_CONFIGS["bloom"])


def test_context_parallel_raises():
    """Context parallelism is ported (a config with it builds), and it
    refuses up front what it does not serve, as the JAX package does: ALiBi
    (a loaded BLOOM), fp8 arenas and prefix-LM attention."""
    from painlessinferenceacceleration_tpu_torch.config import EngineConfig
    from painlessinferenceacceleration_tpu_torch.engine.dist_llm import check_context_parallel

    assert tcfg_mod.ModelConfig(context_parallel=True).context_parallel
    bloom = tcfg_mod.ModelConfig.from_hf(HF_CONFIGS["bloom"])
    with pytest.raises(ValueError, match="alibi"):
        check_context_parallel(bloom, EngineConfig(context_parallel=True))
    with pytest.raises(ValueError, match="fp8"):
        check_context_parallel(tcfg_mod.ModelConfig.tiny(),
                               EngineConfig(context_parallel=True, kv_quant="fp8"))


# ---------------------------------------------------------------------------
# params_from_state_dict against the JAX loader
# ---------------------------------------------------------------------------

E, V, L = 64, 96, 2


def _scheme_configs():
    """A small config dict of every key scheme."""
    small = dict(vocab_size=V, hidden_size=E, num_hidden_layers=L, num_attention_heads=4,
                 intermediate_size=128, max_position_embeddings=64)
    return {
        "llama": dict(small, model_type="llama", num_key_value_heads=2),
        "qwen2": dict(small, model_type="qwen2", num_key_value_heads=2, attention_bias=True),
        "qwen3": dict(small, model_type="qwen3", num_key_value_heads=2, head_dim=16),
        "internlm": dict(small, model_type="internlm", bias=True),
        "mixtral": dict(small, model_type="mixtral", num_key_value_heads=2,
                        num_local_experts=4, num_experts_per_tok=2),
        "qwen3_moe": dict(small, model_type="qwen3_moe", num_key_value_heads=2,
                          num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64),
        "deepseek_v2": dict(small, model_type="deepseek_v2", kv_lora_rank=32,
                            q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=8,
                            v_head_dim=16, n_routed_experts=4, n_shared_experts=1,
                            first_k_dense_replace=1, num_experts_per_tok=2,
                            moe_intermediate_size=64),
        "deepseek_v3": dict(small, model_type="deepseek_v3", hidden_size=256,
                            kv_lora_rank=128, q_lora_rank=128, qk_nope_head_dim=64,
                            qk_rope_head_dim=64, v_head_dim=64, n_routed_experts=4,
                            n_shared_experts=1, first_k_dense_replace=1,
                            num_experts_per_tok=2, moe_intermediate_size=128,
                            intermediate_size=256, n_group=2, topk_group=1),
        "opt": dict(small, model_type="opt", ffn_dim=128, activation_function="relu"),
        "gptj": dict(model_type="gptj", vocab_size=V, n_embd=E, n_layer=L, n_head=4,
                     rotary_dim=8, n_positions=64),
        "baichuan": dict(small, model_type="baichuan"),
        "qwen": dict(small, model_type="qwen", intermediate_size=256),
        "bailing_moe_linear_v2": dict(small, model_type="bailing_moe_linear_v2",
                                      num_key_value_heads=4, layer_group_size=2,
                                      use_qk_norm=True, num_experts=4, num_shared_experts=1,
                                      first_k_dense_replace=1, moe_intermediate_size=64,
                                      num_experts_per_tok=2, n_group=2, topk_group=1),
        "gpt2": dict(model_type="gpt2", vocab_size=V, n_embd=E, n_layer=L, n_head=4,
                     n_positions=64),
        "bloom": dict(model_type="bloom", vocab_size=V, hidden_size=E, n_layer=L, n_head=4),
        "glm": dict(model_type="glm", vocab_size=V, hidden_size=E, num_layers=L,
                    num_attention_heads=4, max_sequence_length=63,
                    block_position_encoding=True, mask_token_ids=[9]),
        "chatglm": dict(model_type="chatglm", vocab_size=V, hidden_size=E, num_layers=L,
                        num_attention_heads=4, multi_query_group_num=2, ffn_hidden_size=128,
                        padded_vocab_size=V, seq_length=64),
    }


SCHEMES = _scheme_configs()


def _state_dict(family: str, cfg, seed: int = 0, dtype=torch.bfloat16) -> dict:
    """Random tensors under the family's HF key names (shapes [out, in])."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    V = cfg.vocab_size
    H, Hk, D, I = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                   cfg.intermediate_size)

    def w(name, *shape):
        sd[name] = (torch.randn(*shape, generator=g) * 0.05).to(dtype)

    def norm(name, n, bias=False):
        sd[name + ".weight"] = (1 + 0.1 * torch.randn(n, generator=g)).to(dtype)
        if bias:
            sd[name + ".bias"] = (0.1 * torch.randn(n, generator=g)).to(dtype)

    def lin(name, dout, din, bias=False):
        w(name + ".weight", dout, din)
        if bias:
            w(name + ".bias", dout)

    if family in ("llama", "qwen2", "qwen3", "internlm", "mixtral", "qwen3_moe",
                  "deepseek_v2", "deepseek_v3"):
        w("model.embed_tokens.weight", V, cfg.hidden_size)
        norm("model.norm", cfg.hidden_size)
        if not cfg.tie_word_embeddings:
            w("lm_head.weight", V, cfg.hidden_size)
        Ex = cfg.hidden_size
        for i in range(L):
            p = f"model.layers.{i}."
            norm(p + "input_layernorm", Ex)
            norm(p + "post_attention_layernorm", Ex)
            a = p + "self_attn."
            if cfg.is_mla:
                nope, rope, vd, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                                     cfg.v_head_dim, cfg.kv_lora_rank)
                lin(a + "kv_a_proj_with_mqa", r + rope, Ex)
                norm(a + "kv_a_layernorm", r)
                lin(a + "kv_b_proj", H * (nope + vd), r)
                lin(a + "o_proj", Ex, H * vd)
                if cfg.q_lora_rank:
                    lin(a + "q_a_proj", cfg.q_lora_rank, Ex)
                    norm(a + "q_a_layernorm", cfg.q_lora_rank)
                    lin(a + "q_b_proj", H * (nope + rope), cfg.q_lora_rank)
                else:
                    lin(a + "q_proj", H * (nope + rope), Ex)
            else:
                b = cfg.attention_bias
                lin(a + "q_proj", H * D, Ex, b)
                lin(a + "k_proj", Hk * D, Ex, b)
                lin(a + "v_proj", Hk * D, Ex, b)
                lin(a + "o_proj", Ex, H * D, cfg.attention_out_bias)
                if cfg.qk_norm:
                    norm(a + "q_norm", D)
                    norm(a + "k_norm", D)
            if cfg.is_moe and i >= cfg.moe_layer_start:
                Im, X = cfg.moe_intermediate_size or I, cfg.num_experts
                if family == "mixtral":
                    lin(p + "block_sparse_moe.gate", X, Ex)
                    for x in range(X):
                        e = p + f"block_sparse_moe.experts.{x}."
                        lin(e + "w1", Im, Ex)
                        lin(e + "w3", Im, Ex)
                        lin(e + "w2", Ex, Im)
                else:
                    lin(p + "mlp.gate", X, Ex)
                    if family == "deepseek_v3":
                        sd[p + "mlp.gate.e_score_correction_bias"] = torch.randn(
                            X, generator=g)
                    for x in range(X):
                        e = p + f"mlp.experts.{x}."
                        lin(e + "gate_proj", Im, Ex)
                        lin(e + "up_proj", Im, Ex)
                        lin(e + "down_proj", Ex, Im)
                    if cfg.num_shared_experts:
                        Ish = Im * cfg.num_shared_experts
                        s = p + "mlp.shared_experts."
                        lin(s + "gate_proj", Ish, Ex)
                        lin(s + "up_proj", Ish, Ex)
                        lin(s + "down_proj", Ex, Ish)
            else:
                lin(p + "mlp.gate_proj", I, Ex)
                lin(p + "mlp.up_proj", I, Ex)
                lin(p + "mlp.down_proj", Ex, I)
        if family == "deepseek_v3":  # the linears as 128x128-block e4m3
            for k in [k for k in sd if k.endswith(".weight") and sd[k].dim() == 2
                      and "layernorm" not in k and "mlp.gate." not in k
                      and not k.startswith(("model.embed", "lm_head"))]:
                n, m = sd[k].shape
                sd[k] = torch.randn(n, m, generator=g).to(torch.float8_e4m3fn)
                sd[k.replace(".weight", ".weight_scale_inv")] = (
                    torch.rand(-(-n // 128), -(-m // 128), generator=g) * 1e-3 + 1e-4)
    elif family == "opt":
        pre = "model.decoder."
        w(pre + "embed_tokens.weight", V, E)
        w(pre + "embed_positions.weight", cfg.max_position_embeddings + 2, E)
        norm(pre + "final_layer_norm", E, True)
        for i in range(L):
            p = pre + f"layers.{i}."
            norm(p + "self_attn_layer_norm", E, True)
            norm(p + "final_layer_norm", E, True)
            for n in "qkv":
                lin(p + f"self_attn.{n}_proj", E, E, True)
            lin(p + "self_attn.out_proj", E, E, True)
            lin(p + "fc1", I, E, True)
            lin(p + "fc2", E, I, True)
    elif family == "gptj":
        w("transformer.wte.weight", V, E)
        norm("transformer.ln_f", E, True)
        lin("lm_head", V, E, True)
        for i in range(L):
            p = f"transformer.h.{i}."
            norm(p + "ln_1", E, True)
            for n in "qkv":
                lin(p + f"attn.{n}_proj", E, E)
            lin(p + "attn.out_proj", E, E)
            lin(p + "mlp.fc_in", I, E, True)
            lin(p + "mlp.fc_out", E, I, True)
    elif family == "baichuan":
        w("model.embed_tokens.weight", V, E)
        norm("model.norm", E)
        w("lm_head.weight", V, E)
        for i in range(L):
            p = f"model.layers.{i}."
            norm(p + "input_layernorm", E)
            norm(p + "post_attention_layernorm", E)
            lin(p + "self_attn.W_pack", 3 * E, E)
            lin(p + "self_attn.o_proj", E, E)
            lin(p + "mlp.gate_proj", I, E)
            lin(p + "mlp.up_proj", I, E)
            lin(p + "mlp.down_proj", E, I)
    elif family == "qwen":
        w("transformer.wte.weight", V, E)
        norm("transformer.ln_f", E)
        w("lm_head.weight", V, E)
        for i in range(L):
            p = f"transformer.h.{i}."
            norm(p + "ln_1", E)
            norm(p + "ln_2", E)
            lin(p + "attn.c_attn", 3 * E, E, True)
            lin(p + "attn.c_proj", E, E)
            lin(p + "mlp.w1", I, E)
            lin(p + "mlp.w2", I, E)
            lin(p + "mlp.c_proj", E, I)
    elif family == "bailing_moe_linear_v2":
        from painlessinferenceacceleration_tpu_torch.models.linear_attn import is_full_layer

        w("model.word_embeddings.weight", V, E)
        norm("model.norm", E)
        w("lm_head.weight", V, E)
        for i in range(L):
            p = f"model.layers.{i}."
            a = p + "attention."
            norm(p + "input_layernorm", E)
            norm(p + "post_attention_layernorm", E)
            lin(a + "query_key_value", (H + 2 * Hk) * D, E)
            lin(a + "dense", E, H * D)
            norm(a + "query_layernorm", D)
            norm(a + "key_layernorm", D)
            if not is_full_layer(cfg, i):
                lin(a + "g_proj", H * D, E)
                norm(a + "g_norm", H * D)
            if i >= cfg.moe_layer_start:
                X, Im = cfg.num_experts, cfg.moe_intermediate_size
                lin(p + "mlp.gate", X, E)
                sd[p + "mlp.gate.expert_bias"] = torch.randn(X, generator=g)
                for x in range(X):
                    e = p + f"mlp.experts.{x}."
                    lin(e + "gate_proj", Im, E)
                    lin(e + "up_proj", Im, E)
                    lin(e + "down_proj", E, Im)
                s = p + "mlp.shared_experts."
                lin(s + "gate_proj", Im, E)
                lin(s + "up_proj", Im, E)
                lin(s + "down_proj", E, Im)
            else:
                lin(p + "mlp.gate_proj", I, E)
                lin(p + "mlp.up_proj", I, E)
                lin(p + "mlp.down_proj", E, I)
    elif family == "gpt2":
        w("transformer.wte.weight", V, E)
        w("transformer.wpe.weight", cfg.max_position_embeddings, E)
        norm("transformer.ln_f", E, True)
        for i in range(L):  # Conv1D weights: [in, out]
            p = f"transformer.h.{i}."
            norm(p + "ln_1", E, True)
            norm(p + "ln_2", E, True)
            w(p + "attn.c_attn.weight", E, 3 * E)
            w(p + "attn.c_attn.bias", 3 * E)
            w(p + "attn.c_proj.weight", E, E)
            w(p + "attn.c_proj.bias", E)
            w(p + "mlp.c_fc.weight", E, I)
            w(p + "mlp.c_fc.bias", I)
            w(p + "mlp.c_proj.weight", I, E)
            w(p + "mlp.c_proj.bias", E)
    elif family == "bloom":
        w("transformer.word_embeddings.weight", V, E)
        norm("transformer.word_embeddings_layernorm", E, True)
        norm("transformer.ln_f", E, True)
        for i in range(L):
            p = f"transformer.h.{i}."
            norm(p + "input_layernorm", E, True)
            norm(p + "post_attention_layernorm", E, True)
            lin(p + "self_attention.query_key_value", 3 * E, E, True)
            lin(p + "self_attention.dense", E, E, True)
            lin(p + "mlp.dense_h_to_4h", I, E, True)
            lin(p + "mlp.dense_4h_to_h", E, I, True)
    elif family == "glm":
        w("glm.word_embeddings.weight", V, E)
        w("glm.transformer.position_embeddings.weight", cfg.max_position_embeddings, E)
        w("glm.transformer.block_position_embeddings.weight", cfg.max_position_embeddings, E)
        norm("glm.transformer.final_layernorm", E, True)
        for i in range(L):
            p = f"glm.transformer.layers.{i}."
            norm(p + "input_layernorm", E, True)
            norm(p + "post_attention_layernorm", E, True)
            lin(p + "attention.query_key_value", 3 * E, E, True)
            lin(p + "attention.dense", E, E, True)
            lin(p + "mlp.dense_h_to_4h", I, E, True)
            lin(p + "mlp.dense_4h_to_h", E, I, True)
    elif family == "chatglm":
        w("transformer.embedding.word_embeddings.weight", V, E)
        norm("transformer.encoder.final_layernorm", E)
        w("transformer.output_layer.weight", V, E)
        for i in range(L):
            p = f"transformer.encoder.layers.{i}."
            norm(p + "input_layernorm", E)
            norm(p + "post_attention_layernorm", E)
            lin(p + "self_attention.query_key_value", (H + 2 * Hk) * D, E, True)
            lin(p + "self_attention.dense", E, H * D)
            lin(p + "mlp.dense_h_to_4h", 2 * I, E)
            lin(p + "mlp.dense_4h_to_h", E, I)
    else:
        raise KeyError(family)
    return sd


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_same_tree(mine, theirs):
    a, b = dict(_leaves(mine)), dict(_leaves(theirs))
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (k, a[k].dtype,
                                                                       b[k].dtype)
        assert _bytes(a[k]) == _bytes(b[k]), k


QUANTS = {"bf16": None, "int4": "int4", "int8": "int8"}
CASES = [(f, q) for f in SCHEMES if f != "deepseek_v3" for q in QUANTS] + [
    ("deepseek_v3", "fp8_block")]


@pytest.mark.parametrize("family,quant", CASES, ids=[f"{f}-{q}" for f, q in CASES])
def test_params_from_state_dict_matches_jax(family, quant):
    conf = SCHEMES[family]
    jc, tc = jcfg_mod.ModelConfig.from_hf(dict(conf)), tcfg_mod.ModelConfig.from_hf(dict(conf))
    sd = _state_dict(family, tc, seed=len(family))
    mode = QUANTS.get(quant, quant)
    jq, tq = JQuantSpec.from_mode(mode), TQuantSpec.from_mode(mode)
    jtree = jhf.params_from_state_dict(sd, jc, jnp.bfloat16, jq)
    ttree = thf.params_from_state_dict(sd, tc, torch.bfloat16, tq, device="cpu")
    _assert_same_tree(ttree, params_from_jax(jax.tree.map(np.asarray, jtree), "cpu"))


def test_qwen2_biases_without_the_config_key(tmp_path):
    """A qwen2 config.json as Qwen publishes it, with no attention_bias key:
    ``from_hf`` still maps the q / k / v biases (HF's Qwen2 always has
    them) and ``load_model`` reads them; a llama checkpoint with q / k / v
    biases that its config does not declare is refused, not served
    without them."""
    conf = {k: v for k, v in SCHEMES["qwen2"].items() if k != "attention_bias"}
    tc = tcfg_mod.ModelConfig.from_hf(dict(conf))
    assert tc.attention_bias and tc == tcfg_mod.ModelConfig.from_hf(SCHEMES["qwen2"])
    sd = _state_dict("qwen2", tc, seed=3)
    st.write_checkpoint(str(tmp_path / "qwen2"), sd, conf, n_shards=1)
    cfg, params, _ = thf.load_model(str(tmp_path / "qwen2"), device="cpu")
    bq = sd["model.layers.0.self_attn.q_proj.bias"]
    assert cfg == tc and torch.equal(params["layers"]["bqkv"][0, :bq.numel()], bq)
    llama = SCHEMES["llama"]
    st.write_checkpoint(str(tmp_path / "llama"), sd, llama, n_shards=1)
    with pytest.raises(ValueError, match="q / k / v biases"):
        thf.load_model(str(tmp_path / "llama"), device="cpu")


def test_load_model_from_a_sharded_directory(tmp_path):
    """load_model reads config.json and the shards through the index; the
    pre-quantized DeepSeek-V3 checkpoint adopts the fp8_block spec."""
    conf = SCHEMES["deepseek_v3"]
    tc = tcfg_mod.ModelConfig.from_hf(dict(conf))
    sd = _state_dict("deepseek_v3", tc, seed=1)
    full = dict(conf, quantization_config={"quant_method": "fp8",
                                           "weight_block_size": [128, 128]})
    st.write_checkpoint(str(tmp_path), sd, full, n_shards=3)
    cfg, params, quant = thf.load_model(str(tmp_path), device="cpu")
    assert quant == TQuantSpec.from_mode("fp8_block") and cfg == tc
    want = thf.params_from_state_dict(sd, tc, torch.bfloat16, quant, device="cpu")
    _assert_same_tree(params, want)
    jcfg, jparams, jquant = jhf.load_model(str(tmp_path))
    _assert_same_tree(params, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))


# ---------------------------------------------------------------------------
# LLM(model_path=...) against the JAX LLM
# ---------------------------------------------------------------------------

class CharTokenizer:
    """Byte-level text <-> ids, offset past the special ids."""

    def encode(self, text):
        return [10 + b for b in text.encode()]

    def decode(self, ids):
        return bytes(max(0, i - 10) % 256 for i in ids).decode("latin-1")


def test_llm_from_model_path_matches_jax(tmp_path):
    conf = dict(model_type="llama", vocab_size=300, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                max_position_embeddings=256, tie_word_embeddings=False)
    cfg = tcfg_mod.ModelConfig.from_hf(conf)
    st.write_checkpoint(str(tmp_path), _state_dict("llama", cfg, seed=9, dtype=torch.float32),
                        conf, n_shards=2)
    from painlessinferenceacceleration_tpu.engine.llm import LLM as JLLM
    from painlessinferenceacceleration_tpu.engine.request import SamplingParams as JSP
    from painlessinferenceacceleration_tpu_torch.engine.llm import LLM as TLLM
    from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams as TSP

    prompts = ["the quick brown fox", "lookahead decoding", "a"]
    kw = dict(page_size=16, max_seq_len=128, max_concurrency=4, eos_token_id=-2)
    tok = CharTokenizer()
    jl = JLLM(model_path=str(tmp_path), ecfg=jcfg_mod.EngineConfig(**kw), tokenizer=tok,
              dtype=jnp.float32)
    tl = TLLM(model_path=str(tmp_path), ecfg=tcfg_mod.EngineConfig(**kw), tokenizer=tok,
              dtype=torch.float32, device="cpu")
    assert tl.cfg == cfg
    jout = [r.output_ids for r in jl.generate(prompts, JSP(max_new_tokens=12))]
    tout = [r.output_ids for r in tl.generate(prompts, TSP(max_new_tokens=12))]
    assert tout == jout and all(len(o) == 12 for o in tout)
    assert isinstance(tl.decode_text(tout[0]), str)
    # a text prompt through the HTTP server reaches LLM.encode
    from painlessinferenceacceleration_tpu_torch.service import client
    from painlessinferenceacceleration_tpu_torch.service.server import StdlibServer

    srv = StdlibServer(tl, host="127.0.0.1", port=0)  # an ephemeral local port
    srv.start()
    try:
        got = client.generate(f"http://127.0.0.1:{srv.port}", prompt=prompts[0],
                              max_new_tokens=12)
    finally:
        srv.stop()
    assert got["output_ids"] == tout[0] and got["text"] == tl.decode_text(tout[0])
