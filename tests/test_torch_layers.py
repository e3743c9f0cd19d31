"""Port layers against ``repro.models.layers`` on the same numpy inputs.

Float32 throughout; tolerance atol = rtol = 1e-5 (the two frameworks sum
in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.models import layers as L

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(name, **kw):
    return (get_config(name).reduced().with_(dtype="float32", **kw),
            jax_config(name).reduced().with_(dtype="float32", **kw))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(ours, theirs):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **TOL)


def test_rmsnorm_and_layernorm():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 3, 5, 16), _rand(rng, 16), _rand(rng, 16)
    _close(L.rmsnorm(torch.tensor(x), torch.tensor(w)), JL.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    _close(L.layernorm(torch.tensor(x), torch.tensor(w), torch.tensor(b)),
           JL.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["gpt-paper", "minitron-4b"])
def test_apply_norm_follows_config(name):
    cfg, jcfg = _cfgs(name)
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 4, cfg.d_model)
    p = {k: _rand(rng, cfg.d_model) for k in ("w", "b")}
    _close(L.apply_norm(cfg, torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()}),
           JL.apply_norm(jcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))


@pytest.mark.parametrize("theta", [10000.0, 500.0, 0.0])
def test_rope(theta):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 7, 3, 32)
    pos = rng.integers(0, 100, (7,)).astype(np.int32)
    _close(L.rope_freqs(32, theta if theta else 1.0), JL.rope_freqs(32, theta if theta else 1.0))
    _close(L.apply_rope(torch.tensor(x), torch.tensor(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("causal,window,H,Kv,use_valid", [
    (True, None, 4, 4, False),     # causal, multi-head
    (False, None, 4, 4, False),    # bidirectional
    (True, 3, 4, 4, False),        # sliding window
    (True, None, 4, 2, False),     # GQA
    (True, 5, 6, 2, True),         # GQA + window + kv_valid
])
def test_gqa_attention(causal, window, H, Kv, use_valid):
    rng = np.random.default_rng(3)
    B, Sq, Skv, hd = 2, 6, 9, 16
    q, k, v = _rand(rng, B, Sq, H, hd), _rand(rng, B, Skv, Kv, hd), _rand(rng, B, Skv, Kv, hd)
    q_pos = np.arange(Skv - Sq, Skv, dtype=np.int32)
    kv_pos = np.arange(Skv, dtype=np.int32)
    valid = rng.random(Skv) > 0.3 if use_valid else None
    if valid is not None:
        valid[0] = True
    ours = L.gqa_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        q_pos=torch.tensor(q_pos), kv_pos=torch.tensor(kv_pos), causal=causal,
        window=window, kv_valid=None if valid is None else torch.tensor(valid))
    theirs = JL.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos), causal=causal,
        window=window, kv_valid=None if valid is None else jnp.asarray(valid))
    _close(ours, theirs)
    mask = L.attention_scores_mask(torch.tensor(q_pos), torch.tensor(kv_pos),
                                   causal=causal, window=window)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(JL.attention_scores_mask(
        jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=causal, window=window)))


@pytest.mark.parametrize("name", ["gpt-paper", "minitron-4b"])
def test_attn_project_qkv(name):
    cfg, jcfg = _cfgs(name)
    rng = np.random.default_rng(4)
    d, hd = cfg.d_model, cfg.hd
    s = np.float32(1 / np.sqrt(d))
    p = {"wq": _rand(rng, d, cfg.n_heads * hd) * s, "wk": _rand(rng, d, cfg.n_kv_heads * hd) * s,
         "wv": _rand(rng, d, cfg.n_kv_heads * hd) * s}
    x = _rand(rng, 2, 5, d)
    pos = np.arange(3, 8, dtype=np.int32)
    ours = L.attn_project_qkv(cfg, {k: torch.tensor(v) for k, v in p.items()},
                              torch.tensor(x), torch.tensor(pos))
    theirs = JL.attn_project_qkv(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), jnp.asarray(pos))
    for a, b in zip(ours, theirs):
        _close(a, b)


@pytest.mark.parametrize("act", ["gelu", "swiglu", "geglu"])
def test_mlp(act):
    cfg, jcfg = _cfgs("minitron-4b", act=act)
    rng = np.random.default_rng(5)
    d, f = cfg.d_model, cfg.d_ff
    gated = act != "gelu"
    p = {"w_in": _rand(rng, d, 2 * f if gated else f) / np.float32(np.sqrt(d)),
         "w_out": _rand(rng, f, d) / np.float32(np.sqrt(f))}
    x = _rand(rng, 2, 3, d)
    _close(L.mlp(cfg, {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x)),
           JL.mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["gpt-paper", "minitron-4b"])
def test_embed_unembed_with_vocab_padding(name):
    cfg, jcfg = _cfgs(name, vocab_size=300)   # pads to 512
    assert cfg.vocab_padded == 512
    rng = np.random.default_rng(6)
    p = {"embedding": _rand(rng, cfg.vocab_padded, cfg.d_model)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _rand(rng, cfg.d_model, cfg.vocab_padded)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tok = rng.integers(0, cfg.vocab_size, (2, 5))
    _close(L.embed(cfg, tp, torch.tensor(tok)), JL.embed(jcfg, jp, jnp.asarray(tok)))
    h = _rand(rng, 2, 5, cfg.d_model)
    ours = L.unembed(cfg, tp, torch.tensor(h))
    _close(ours, JL.unembed(jcfg, jp, jnp.asarray(h)))
    assert (ours[..., cfg.vocab_size:] == -1e30).all()
