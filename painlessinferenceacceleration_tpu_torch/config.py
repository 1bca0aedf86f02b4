"""Model / engine configuration for the PyTorch port.

A copy of ``painlessinferenceacceleration_tpu.config``'s model fields: the
llama family (with qwen3's per-head QK norm), the Mixture-of-Experts fields
of the mixtral / qwen3_moe / deepseek class, the Multi-head Latent
Attention fields of deepseek v2 / v3, the linear-attention hybrid fields
of the Ring / Bailing-linear class and the legacy dense families' knobs
(gpt2, opt, gptj, bloom, glm, chatglm, baichuan, qwen1: layer norm, learned,
ALiBi and GLM 2D positions, biases, un-gated MLPs, parallel residuals,
partial and interleaved rope). The port imports nothing from the JAX
package. Field names follow HF ``config.json`` keys, as in the JAX package,
with the same defaults, so one set of keyword arguments builds the same
model in both packages, and ``ModelConfig.from_hf`` maps a checkpoint's
``config.json`` as the JAX one does.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of a decoder-only transformer: the dense llama family
    (llama, qwen3) or its Mixture-of-Experts form (mixtral, qwen3_moe,
    deepseek_v2 / v3), where the layers from ``moe_layer_start`` on replace
    the MLP by routed experts (and optional always-on shared experts); with
    ``kv_lora_rank`` > 0 the attention is Multi-head Latent Attention
    (``models/mla.py``); with ``linear_attention`` the model is a hybrid of
    linear-attention layers and, every ``layer_group_size``-th layer, full
    attention (``models/linear_attn.py``). The legacy dense families set the
    knobs below ``hidden_act`` (``models/base.py``)."""

    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int = 0  # 0 -> hidden_size // num_attention_heads
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # bias on the fused qkv projection
    mlp_bias: bool = False  # biases on the MLP's up (gate-up) and down projections
    hidden_act: str = "silu"
    qk_norm: bool = False  # qwen3: per-head RMSNorm on q and k before rope
    # legacy-family knobs. "glm_2d" is AntGLM's two learned tables (position
    # and block position); "alibi" adds slope[h] * key position to the scores
    position_embedding_type: str = "rope"  # rope | learned | alibi | glm_2d
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    # prefix-LM attention (AntGLM): prompt tokens see the whole prompt,
    # generated tokens are causal
    prefix_lm: bool = False
    # [MASK] / [sMASK] / [gMASK] ids: the first one in a prompt anchors the
    # generated tokens' GLM positions
    mask_token_ids: Tuple[int, ...] = ()
    gated_mlp: bool = True  # False: one up projection + activation (gpt2, bloom)
    attention_out_bias: bool = False  # bias on the output projection
    embed_layernorm: bool = False  # bloom's word_embeddings_layernorm
    # gptj: one pre-norm feeds attention and the MLP, h += attn + mlp
    parallel_residual: bool = False
    partial_rotary_factor: float = 1.0  # share of the head dim that rope rotates
    rope_interleaved: bool = False  # GPT-J / chatglm pairs (2i, 2i + 1)
    # HF rope_scaling dict ("rope_type" / "type": default, linear, llama3,
    # yarn), kept as a sorted item tuple
    rope_scaling: Optional[tuple] = None
    # MoE (mixtral / qwen3_moe / deepseek class)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0  # 0 -> intermediate_size
    num_shared_experts: int = 0
    moe_layer_start: int = 0  # dense layers before the MoE layers
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # deepseek-v3 routing: sigmoid scoring + group-limited top-k
    scoring_func: str = "softmax"  # softmax | sigmoid
    n_group: int = 0
    topk_group: int = 0
    # expert parallelism: the expert axis of the stacked expert weights is
    # split into shards (models/moe.py expert_shards)
    expert_parallel: bool = False
    # MLA (deepseek v2 / v3); kv_lora_rank 0 disables it
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # cache the rms-normed latent and the roped k_pe once per token and run
    # weight-absorbed MQA over them (K13), instead of per-head K / V rows
    mla_latent_cache: bool = False
    # linear-attention hybrids (Ring / Bailing-linear): every
    # layer_group_size-th layer is full attention, the others linear with a
    # recurrent state (0 = all linear)
    linear_attention: bool = False
    layer_group_size: int = 0
    # bailing-linear-v2 linear layers apply per-head q/k RMSNorm and rope
    # before the feature map
    linear_qk_norm: bool = False
    linear_rope: bool = False
    # context parallelism: the KV pages split over the model axis of a
    # DistLLM (ops/cp_attention.py); set from EngineConfig.context_parallel
    context_parallel: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(
                self, "head_dim", self.hidden_size // self.num_attention_heads
            )
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(
                self, "rope_scaling", tuple(sorted(self.rope_scaling.items()))
            )
        if isinstance(self.mask_token_ids, list):
            object.__setattr__(self, "mask_token_ids", tuple(self.mask_token_ids))

    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @classmethod
    def from_hf(cls, conf: "dict | str") -> "ModelConfig":
        """Build from an HF config dict, or a path to a model dir or its
        ``config.json``: the JAX package's ``ModelConfig.from_hf``, branch
        for branch (the HF keys of each family mapped onto the fields), but
        for qwen2's q / k / v biases, which are always there.
        ``mla_latent_cache`` stays False, as there: a DeepSeek checkpoint
        comes up in expanded mode."""
        if isinstance(conf, str):
            path = conf
            if os.path.isdir(path):
                path = os.path.join(path, "config.json")
            with open(path) as f:
                conf = json.load(f)
        mt = conf.get("model_type", "llama")
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs: dict = {k: v for k, v in conf.items() if k in known}
        kwargs["model_type"] = mt
        # model-family aliases
        if mt in ("qwen3", "qwen3_moe"):
            kwargs["qk_norm"] = True
        if mt == "qwen2":
            # HF's Qwen2Attention always puts biases on q, k and v, and the
            # published Qwen2 / Qwen2.5 config.json has no attention_bias key
            # (the JAX package reads the key alone, and so drops them)
            kwargs["attention_bias"] = True
        if mt in ("mixtral",):
            kwargs["num_experts"] = conf.get("num_local_experts", 0)
        if "num_experts_per_tok" in conf and "num_experts" not in kwargs:
            kwargs["num_experts"] = conf.get("num_experts", 0)
        if mt in ("deepseek_v2", "deepseek_v3"):
            kwargs["moe_layer_start"] = conf.get("first_k_dense_replace", 1)
            kwargs["num_shared_experts"] = conf.get("n_shared_experts", 0) or 0
            kwargs["num_experts"] = conf.get("n_routed_experts", 0) or 0
            kwargs["q_lora_rank"] = conf.get("q_lora_rank", 0) or 0
            kwargs["kv_lora_rank"] = conf.get("kv_lora_rank", 0) or 0
            kwargs["scoring_func"] = conf.get("scoring_func", "sigmoid" if mt == "deepseek_v3" else "softmax")
            kwargs["routed_scaling_factor"] = conf.get("routed_scaling_factor", 1.0)
        if mt == "opt":
            kwargs.update(
                intermediate_size=conf.get("ffn_dim", 4 * conf.get("hidden_size", 768)),
                rms_norm_eps=1e-5,
                position_embedding_type="learned",
                norm_type="layernorm",
                gated_mlp=False,
                hidden_act=conf.get("activation_function", "relu"),
                attention_bias=True,
                attention_out_bias=True,
                mlp_bias=True,
                tie_word_embeddings=bool(conf.get("tie_word_embeddings", True)),
            )
        if mt == "gptj":
            kwargs.update(
                hidden_size=conf.get("n_embd", 4096),
                num_hidden_layers=conf.get("n_layer", 28),
                num_attention_heads=conf.get("n_head", 16),
                num_key_value_heads=conf.get("n_head", 16),
                intermediate_size=conf.get("n_inner") or 4 * conf.get("n_embd", 4096),
                max_position_embeddings=conf.get("n_positions", 2048),
                rms_norm_eps=conf.get("layer_norm_epsilon", 1e-5),
                norm_type="layernorm",
                gated_mlp=False,
                hidden_act=conf.get("activation_function", "gelu_new"),
                parallel_residual=True,
                rope_interleaved=True,
                partial_rotary_factor=(
                    conf.get("rotary_dim", 64)
                    / (conf.get("n_embd", 4096) // conf.get("n_head", 16))
                ),
                mlp_bias=True,
                tie_word_embeddings=False,
            )
        if mt == "internlm":  # llama arch + qkv/o biases (conf["bias"])
            kwargs["attention_bias"] = bool(conf.get("bias", True))
            kwargs["attention_out_bias"] = bool(conf.get("bias", True))
        if mt == "baichuan":
            # 7B rope; 13B (40 heads, E = 5120) ALiBi: the HF config carries
            # no flag, the modeling file keys off the model's size
            if conf.get("num_attention_heads", 32) >= 40:
                kwargs["position_embedding_type"] = "alibi"
            kwargs["tie_word_embeddings"] = False
        if mt == "qwen":  # qwen1: fused c_attn + halved ff width (w1/w2)
            kwargs.update(
                intermediate_size=conf.get("intermediate_size", 22016) // 2,
                rms_norm_eps=conf.get("layer_norm_epsilon", 1e-6),
                attention_bias=True,
                attention_out_bias=False,
                rope_theta=conf.get("rotary_emb_base", 10000.0),
                tie_word_embeddings=False,
            )
        if mt in ("bailing_moe_linear_v2", "bailing_moe_linear"):
            # the Ring / Bailing linear-attention hybrid
            kwargs["linear_attention"] = True
            kwargs["layer_group_size"] = conf.get("layer_group_size", 1)
            kwargs["linear_qk_norm"] = True
            kwargs["linear_rope"] = True
            kwargs["qk_norm"] = bool(conf.get("use_qk_norm", False))
            kwargs["moe_layer_start"] = conf.get("first_k_dense_replace", 0)
            kwargs["num_experts"] = conf.get("num_experts", 0) or 0
            kwargs["num_shared_experts"] = conf.get("num_shared_experts", 0) or 0
            if conf.get("moe_intermediate_size"):
                kwargs["moe_intermediate_size"] = conf["moe_intermediate_size"]
            # the experts are sigmoid-scored, with the gate's expert_bias
            kwargs["scoring_func"] = "sigmoid"
            kwargs["n_group"] = conf.get("n_group", 0) or 0
            kwargs["topk_group"] = conf.get("topk_group", 0) or 0
            kwargs["routed_scaling_factor"] = conf.get("routed_scaling_factor", 1.0)
            kwargs["norm_topk_prob"] = bool(conf.get("norm_topk_prob", True))
            kwargs["linear_rope"] = bool(conf.get("linear_rope", True))
            kwargs["attention_bias"] = bool(conf.get("use_qkv_bias", False))
            kwargs["attention_out_bias"] = bool(conf.get("use_bias", False))
            if conf.get("use_linear_gqa"):
                raise NotImplementedError(
                    "bailing use_linear_gqa checkpoints are not supported "
                    "(linear layers here are MHA; see models/linear_attn.py)"
                )
        if mt == "gpt2":
            kwargs.update(
                vocab_size=conf.get("vocab_size", 50257),
                hidden_size=conf.get("n_embd", 768),
                num_hidden_layers=conf.get("n_layer", 12),
                num_attention_heads=conf.get("n_head", 12),
                num_key_value_heads=conf.get("n_head", 12),
                intermediate_size=conf.get("n_inner") or 4 * conf.get("n_embd", 768),
                max_position_embeddings=conf.get("n_positions", 1024),
                rms_norm_eps=conf.get("layer_norm_epsilon", 1e-5),
                position_embedding_type="learned",
                norm_type="layernorm",
                gated_mlp=False,
                hidden_act=conf.get("activation_function", "gelu_new"),
                attention_bias=True,
                attention_out_bias=True,
                mlp_bias=True,
                tie_word_embeddings=True,
            )
        if mt == "bloom":
            E = conf.get("hidden_size", conf.get("n_embed", 1024))
            kwargs.update(
                hidden_size=E,
                num_hidden_layers=conf.get("n_layer", 24),
                num_attention_heads=conf.get("n_head", 16),
                num_key_value_heads=conf.get("n_head", 16),
                intermediate_size=4 * E,
                rms_norm_eps=conf.get("layer_norm_epsilon", 1e-5),
                position_embedding_type="alibi",
                norm_type="layernorm",
                gated_mlp=False,
                hidden_act="gelu_new",  # BloomGelu == tanh-approx gelu
                attention_bias=True,
                attention_out_bias=True,
                mlp_bias=True,
                embed_layernorm=True,
                tie_word_embeddings=True,
            )
        if mt == "glm" and (
            "block_position_encoding" in conf or "max_sequence_length" in conf
        ):
            # AntGLM / GLM-10B: LayerNorm blocks, un-gated GELU MLP, biases
            # everywhere, two learned position tables (position + block
            # position), prefix-LM attention, tied LM head
            E = conf.get("hidden_size", 1024)
            kwargs.update(
                vocab_size=conf.get("vocab_size", 30592),
                hidden_size=E,
                num_hidden_layers=conf.get("num_layers", 24),
                num_attention_heads=conf.get("num_attention_heads", 16),
                num_key_value_heads=conf.get("num_attention_heads", 16),
                intermediate_size=conf.get("bottleneck_size") or 4 * E,
                max_position_embeddings=conf.get("max_sequence_length", 512) + 1,
                rms_norm_eps=1e-5,  # nn.LayerNorm default (modeling_glm.py:227)
                position_embedding_type="glm_2d",
                norm_type="layernorm",
                gated_mlp=False,
                hidden_act="gelu",  # F.gelu exact (modeling_glm.py:26)
                attention_bias=True,
                attention_out_bias=True,
                mlp_bias=True,
                prefix_lm=True,
                tie_word_embeddings=True,
                mask_token_ids=tuple(conf.get("mask_token_ids", ())),
            )
        elif mt in ("chatglm", "glm"):
            # chatglm2/3: MQA + RMSNorm + swiglu + rope on half the head dim,
            # interleaved pairs
            kwargs.update(
                vocab_size=conf.get("padded_vocab_size", conf.get("vocab_size", 65024)),
                num_hidden_layers=conf.get("num_layers", 28),
                num_key_value_heads=conf.get(
                    "multi_query_group_num", conf.get("num_attention_heads", 32)
                ),
                intermediate_size=conf.get("ffn_hidden_size", 13696),
                rms_norm_eps=conf.get("layernorm_epsilon", 1e-5),
                max_position_embeddings=conf.get("seq_length", 8192),
                rope_theta=10000.0 * conf.get("rope_ratio", 1.0),
                attention_bias=bool(conf.get("add_qkv_bias", True)),
                partial_rotary_factor=0.5,
                rope_interleaved=True,
                tie_word_embeddings=False,
            )
        if "num_key_value_heads" not in kwargs:
            kwargs["num_key_value_heads"] = kwargs.get(
                "num_attention_heads", cls.num_attention_heads
            )
        if conf.get("head_dim") is None:
            kwargs.pop("head_dim", None)
        return cls(**kwargs)

    @classmethod
    def tiny(cls, **over) -> "ModelConfig":
        """A tiny random-weight llama for CPU tests (same as the JAX preset)."""
        kw = dict(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=3,
            num_attention_heads=4,
            num_key_value_heads=2,
            max_position_embeddings=512,
        )
        kw.update(over)
        return cls(**kw)

    @classmethod
    def tiny_gpt2(cls, **over) -> "ModelConfig":
        kw = dict(
            model_type="gpt2",
            vocab_size=512,
            hidden_size=64,
            intermediate_size=256,
            num_hidden_layers=3,
            num_attention_heads=4,
            num_key_value_heads=4,
            max_position_embeddings=512,
            position_embedding_type="learned",
            norm_type="layernorm",
            gated_mlp=False,
            hidden_act="gelu_new",
            attention_bias=True,
            attention_out_bias=True,
            mlp_bias=True,
            tie_word_embeddings=True,
        )
        kw.update(over)
        return cls(**kw)

    @classmethod
    def tiny_bloom(cls, **over) -> "ModelConfig":
        kw = dict(
            model_type="bloom",
            vocab_size=512,
            hidden_size=64,
            intermediate_size=256,
            num_hidden_layers=3,
            num_attention_heads=4,
            num_key_value_heads=4,
            max_position_embeddings=512,
            position_embedding_type="alibi",
            norm_type="layernorm",
            gated_mlp=False,
            hidden_act="gelu_new",
            attention_bias=True,
            attention_out_bias=True,
            mlp_bias=True,
            embed_layernorm=True,
            tie_word_embeddings=True,
        )
        kw.update(over)
        return cls(**kw)

    @classmethod
    def tiny_chatglm(cls, **over) -> "ModelConfig":
        kw = dict(
            model_type="chatglm",
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=3,
            num_attention_heads=4,
            num_key_value_heads=2,
            max_position_embeddings=512,
            attention_bias=True,
            partial_rotary_factor=0.5,
            rope_interleaved=True,
        )
        kw.update(over)
        return cls(**kw)

    @classmethod
    def llama2_7b(cls) -> "ModelConfig":
        return cls()

    @classmethod
    def mixtral_8x7b(cls) -> "ModelConfig":
        """The widths of mistralai/Mixtral-8x7B-v0.1's ``config.json``."""
        return cls(model_type="mixtral", vocab_size=32000, hidden_size=4096,
                   intermediate_size=14336, num_hidden_layers=32,
                   num_attention_heads=32, num_key_value_heads=8,
                   rms_norm_eps=1e-5, rope_theta=1e6, num_experts=8,
                   num_experts_per_tok=2)

    @classmethod
    def mla_3b(cls) -> "ModelConfig":
        """The JAX package's DeepSeek-V2-Lite-shaped MLA model with a dense
        MLP (MLA pairs its rope dims interleaved whatever
        ``rope_interleaved`` says)."""
        return cls(model_type="deepseek_v2", hidden_size=2048, intermediate_size=8192,
                   num_hidden_layers=24, num_attention_heads=16,
                   num_key_value_heads=16, q_lora_rank=0, kv_lora_rank=512,
                   qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                   mla_latent_cache=True, rope_interleaved=True,
                   max_position_embeddings=4096)

    @classmethod
    def deepseek_v2_lite(cls) -> "ModelConfig":
        """The widths of deepseek-ai/DeepSeek-V2-Lite's ``config.json``
        (``q_lora_rank`` null there), served from the latent cache."""
        return cls(model_type="deepseek_v2", vocab_size=102400, hidden_size=2048,
                   intermediate_size=10944, moe_intermediate_size=1408,
                   max_position_embeddings=163840,
                   num_hidden_layers=27, num_attention_heads=16,
                   num_key_value_heads=16, rms_norm_eps=1e-6, rope_theta=10000.0,
                   rope_scaling={"beta_fast": 32, "beta_slow": 1, "factor": 40,
                                 "mscale": 0.707, "mscale_all_dim": 0.707,
                                 "original_max_position_embeddings": 4096,
                                 "type": "yarn"},
                   num_experts=64, num_experts_per_tok=6, num_shared_experts=2,
                   moe_layer_start=1, scoring_func="softmax", norm_topk_prob=False,
                   routed_scaling_factor=1.0, n_group=1, topk_group=1,
                   q_lora_rank=0, kv_lora_rank=512, qk_nope_head_dim=128,
                   qk_rope_head_dim=64, v_head_dim=128, mla_latent_cache=True)

    @classmethod
    def ring_mini_linear_2(cls) -> "ModelConfig":
        """inclusionAI/Ring-mini-linear-2.0 (``config.json`` model type
        ``bailing_moe_linear_v2``) as the JAX package's ``ModelConfig.from_hf``
        maps it: 20 layers of which every 5th (4, 9, 14, 19) is full attention
        (16 heads, 4 KV heads, per-head q/k norm) and the other 16 linear
        attention over the 16 heads with per-head q/k norm and rope; a dense
        first layer (``first_k_dense_replace`` 1), then 256 sigmoid-scored
        experts of 512 in 8 groups (top 4 groups, top 8 experts, scaling
        2.5, expert bias) and one shared expert. The values are the published
        ones as the porting notes read them; no copy of the file is in this
        repository. The two that matter most to re-check against one are
        ``layer_group_size`` (the layer pattern) and ``num_key_value_heads``
        (the full layers' grouped-query attention)."""
        return cls(model_type="bailing_moe_linear_v2", vocab_size=157184,
                   hidden_size=2048, intermediate_size=5120,
                   moe_intermediate_size=512, num_hidden_layers=20,
                   num_attention_heads=16, num_key_value_heads=4, head_dim=128,
                   rms_norm_eps=1e-6, rope_theta=600000.0, tie_word_embeddings=False,
                   qk_norm=True, num_experts=256, num_experts_per_tok=8,
                   num_shared_experts=1, moe_layer_start=1, norm_topk_prob=True,
                   routed_scaling_factor=2.5, scoring_func="sigmoid", n_group=8,
                   topk_group=4, linear_attention=True, layer_group_size=5,
                   linear_qk_norm=True, linear_rope=True)


# Decode-batch buckets: batch widths snap to this ladder (as in the JAX
# package, where each width is one compiled program; here it bounds the
# number of distinct shapes the kernels see).
DEFAULT_DECODE_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)

SCHEDULE_POLICIES = ("pingpong", "mix", "timely")


def cp_page_unit(axis: int) -> int:
    """The arena's page count under context parallelism is a multiple of
    this: lcm(16, model axis)."""
    return 16 * axis // math.gcd(16, axis)

KV_QUANT_MODES = ("none", "fp8", "fp8_tok")
# the modes layers.linear.QuantSpec.from_mode takes
QUANT_MODES = ("none", "int8", "int4", "w8a8_int8", "w8a8_int8_static",
               "w8a8_fp8", "w8a8_fp8_static", "fp8_block", "fp8_tb")


@dataclasses.dataclass
class EngineConfig:
    """Serving-engine configuration: the serving fields of the JAX
    ``EngineConfig``, with the same names and defaults."""

    # --- KV arena ---
    page_size: int = 64  # tokens per KV page
    num_pages: int = 0  # 0 -> sized from max_concurrency * max_seq_len
    # > 0: size num_pages from this fraction of the card's free memory at
    # engine construction (after the parameters are resident)
    cache_memory_fraction: float = 0.0
    max_seq_len: int = 2048  # max context per request
    max_concurrency: int = 64  # max resident requests

    # --- batching ---
    prefill_chunk: int = 512  # chunked-prefill tokens per request and step
    decode_buckets: Tuple[int, ...] = DEFAULT_DECODE_BUCKETS
    # decode steps per scheduler burst; the idle length applies when no
    # admission can happen during the burst
    decode_burst: int = 8
    decode_burst_idle: int = 32
    # pingpong: a prefill phase, then a decode phase; timely: decode first;
    # mix: width-1 decode rows ride in the prefill batches
    schedule_policy: str = "pingpong"
    # admit queued requests only once this many slots are free
    admit_min_free: int = 1

    # --- lookahead ---
    use_lookahead: bool = False
    decoding_length: int = 63  # draft tokens per verify step
    branch_length: int = 12  # tokens per draft branch
    decoding_mode: str = "hier"  # LookaheadGenerator's trie drafts: hier | par | one
    use_spec_min_batch_size: int = 4  # spec only when the batch is this small
    # after a spec burst whose drafts were retrievable on fewer than
    # spec_gate_threshold of its steps, run this many AR bursts (0: never)
    spec_cooldown_bursts: int = 4
    spec_gate_threshold: float = 0.25

    # --- prefix caching ---
    prefix_cache: bool = True  # page-granular shared-prefix KV reuse

    # --- quantization ---
    # none | int8 | int4 (weight-only) | w8a8_int8[_static] | w8a8_fp8[_static]
    # | fp8_block | fp8_tb
    quant: str = "none"
    kv_quant: str = "none"  # none | fp8 (static per-head) | fp8_tok (per token)
    quant_group: int = 128
    quant_embed: bool = False  # retype the embedding table to per-row e4m3
    kv_scale_init: float = 1.0  # initial static fp8 scale (before calibration)

    # --- parallelism (engine/dist_llm.py DistLLM) ---
    mesh_shape: Optional[Tuple[int, ...]] = None  # (data, model); None -> all model
    mesh_axes: Tuple[str, ...] = ("data", "model")
    # the KV pages split over the model axis (ModelConfig.context_parallel)
    context_parallel: bool = False

    # --- sampling defaults (inert, as in the JAX package: requests carry
    # their own SamplingParams) ---
    temperature: float = 0.0  # 0 -> greedy
    top_k: int = 0
    top_p: float = 1.0

    # --- misc ---
    eos_token_id: int = 2
    # LookaheadGenerator's default; LLM requests take SamplingParams.max_new_tokens
    max_new_tokens: int = 256

    def __post_init__(self):
        if self.kv_quant not in KV_QUANT_MODES:
            raise ValueError(f"kv_quant {self.kv_quant!r} not in {KV_QUANT_MODES}")
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant {self.quant!r} not in {QUANT_MODES}")
        if self.schedule_policy not in SCHEDULE_POLICIES:
            raise ValueError(f"schedule_policy {self.schedule_policy!r} not in "
                             f"{SCHEDULE_POLICIES}")
        if self.num_pages == 0:
            # +1: page 0 is the reserved null page (padding page-table entries)
            self.num_pages = self.max_concurrency * self.pages_per_req + 1
        if self.context_parallel:
            # the model axis splits the pages: round them up to a multiple of
            # lcm(16, axis) once (the JAX package rounds to 16 here and to the
            # axis in DistLLM, and the second rounding can undo the first)
            unit = cp_page_unit(self.mesh_shape[-1] if self.mesh_shape else 1)
            self.num_pages = -(-self.num_pages // unit) * unit

    @property
    def pages_per_req(self) -> int:
        return -(-self.max_seq_len // self.page_size)
