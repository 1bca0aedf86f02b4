"""The port's legacy families against HF's torch models, on the CPU.

gpt2, bloom, opt and gptj: an HF model at a tiny size (random init, seeded)
is loaded into the port through ``models/hf_loader.py``
``params_from_torch_model`` (its own state dict, HF key names) with
``ModelConfig.from_hf`` of its config, and the port's fp32 logits over a
prompt must match HF's forward within 3e-4 (the JAX package's tolerance in
``tests/test_legacy_models*.py``). Skipped where ``transformers`` is not
importable.
"""

import numpy as np
import pytest
import torch

from painlessinferenceacceleration_tpu_torch import config as tcfg_mod
from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache
from painlessinferenceacceleration_tpu_torch.models import base as tbase

PAGE, MAX_SEQ = 16, 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HF_CASES = {
    "gpt2": ("GPT2Config", "GPT2LMHeadModel",
             dict(vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=128,
                  resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)),
    "bloom": ("BloomConfig", "BloomForCausalLM",
              dict(vocab_size=256, hidden_size=64, n_layer=2, n_head=4,
                   hidden_dropout=0.0, attention_dropout=0.0)),
    "opt": ("OPTConfig", "OPTForCausalLM",
            dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                 ffn_dim=128, max_position_embeddings=128, word_embed_proj_dim=64,
                 do_layer_norm_before=True, dropout=0.0, activation_function="relu")),
    "gptj": ("GPTJConfig", "GPTJForCausalLM",
             dict(vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=128,
                  rotary_dim=8, activation_function="gelu_new", resid_pdrop=0.0,
                  embd_pdrop=0.0, attn_pdrop=0.0)),
}


@pytest.mark.parametrize("family", list(HF_CASES))
def test_legacy_family_matches_hf(family):
    """The port loads an HF model's own state dict (``params_from_torch_model``)
    and its logits over a prompt match HF's forward."""
    transformers = pytest.importorskip("transformers")
    from painlessinferenceacceleration_tpu_torch.models.hf_loader import (
        params_from_torch_model,
    )

    conf_cls, model_cls, kw = HF_CASES[family]
    torch.manual_seed(0)
    hf_cfg = getattr(transformers, conf_cls)(**kw)
    model = getattr(transformers, model_cls)(hf_cfg).eval()
    cfg = tcfg_mod.ModelConfig.from_hf(hf_cfg.to_dict())
    params = params_from_torch_model(model, cfg, dtype=torch.float32, device="cpu")
    ids = [5, 17, 201, 42, 9, 150, 77, 80]
    T = len(ids)
    te = tcfg_mod.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=1)
    kv = init_kv_cache(cfg, te, dtype=torch.float32, device="cpu")
    pt = torch.arange(1, 1 + te.pages_per_req, dtype=torch.int32)[None]
    i = torch.arange(T)
    h, _ = tbase.transformer_hidden(params, cfg, kv, torch.tensor([ids], dtype=torch.int32),
                                    i[None], pt, torch.zeros(1, dtype=torch.int32),
                                    (i[:, None] >= i[None, :])[None], causal_window=True)
    got = tbase.logits_from_hidden(params, cfg, h)[0].numpy()
    with torch.no_grad():
        want = model(torch.tensor([ids])).logits[0].float().numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)
