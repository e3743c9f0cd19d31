"""The port's serving caches, decode step and prefill against the JAX package's.

``cache_width`` / ``cache_specs`` / ``init_cache``, ``prefill`` (with the ring
roll when the prompt is longer than a sliding window, and the vlm patch
frontend) and ``decode_step`` (one batched step, a position per row, where
the JAX package's serving vmaps a one-row step) are held against
``repro.models.model`` on ``reduced()`` configs in float32, weights from the
JAX ``init_params`` carried over by ``repro_torch.interop``.  Logits and
every cache leaf agree to atol 1e-5; decode logits against a forward over
the sequence so far to atol 1e-4 (a longer chain of sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import model as M

torch.set_num_threads(2)
ATOL = 1e-5          # same function, same order of sums up to the products
ATOL_FWD = 1e-4      # decode against the forward over the whole sequence


def _pair(name, **over):
    cfg = get_config(name).reduced().with_(dtype="float32", **over)
    jcfg = jax_config(name).reduced().with_(dtype="float32", **over)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams, params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                 device="cpu")


def _leaves_close(ours, theirs, atol=ATOL):
    ol, tl = jax.tree.leaves(ours), jax.tree.leaves(theirs)
    assert len(ol) == len(tl)
    for a, b in zip(ol, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("name,over,max_len", [
    ("gpt-paper", {}, 64),
    ("phi3-mini-3.8b", {}, 64),                         # window 32 < 64: ring of 32
    ("phi3-mini-3.8b", {"scan_layers": False}, 64),
    ("internvl2-1b", {}, 48),
])
def test_cache_specs_match_jax(name, over, max_len):
    cfg = get_config(name).reduced().with_(**over)
    jcfg = jax_config(name).reduced().with_(**over)
    assert M.cache_width(cfg, max_len) == JM.cache_width(jcfg, max_len)
    ours, theirs = M.cache_specs(cfg, 3, max_len), JM.cache_specs(jcfg, 3, max_len)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, theirs))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    cache = M.init_cache(cfg, 3, max_len, device="cpu")
    assert all(float(t.abs().sum()) == 0.0 for t in jax.tree.leaves(cache))


@pytest.mark.parametrize("name,over,S,max_len", [
    ("gpt-paper", {}, 13, 32),
    ("phi3-mini-3.8b", {"sliding_window": 8}, 5, 32),                         # S < window
    ("phi3-mini-3.8b", {"sliding_window": 8}, 21, 32),                        # the roll
    ("phi3-mini-3.8b", {"sliding_window": 8, "scan_layers": False}, 21, 32),
], ids=["gpt", "phi3-short", "phi3-roll", "phi3-roll-list"])
def test_prefill_matches_jax(name, over, S, max_len):
    cfg, jcfg, jparams, params = _pair(name, **over)
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (1, S))
    lj, cj = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, max_len)
    lt, ct = M.prefill(cfg, params, {"tokens": torch.tensor(toks)}, max_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    _leaves_close(ct, cj)


def test_prefill_vlm_patches_match_jax():
    cfg, jcfg, jparams, params = _pair("internvl2-1b")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (1, 6))
    patches = rng.standard_normal((1, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    lj, cj = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                        "patches": jnp.asarray(patches)}, 32)
    lt, ct = M.prefill(cfg, params, {"tokens": torch.tensor(toks),
                                     "patches": torch.tensor(patches)}, 32)
    assert lt.shape[1] == cfg.n_frontend_tokens + 6
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    _leaves_close(ct, cj)


@pytest.mark.parametrize("name", ["gpt-paper", "internvl2-1b"])
def test_prefill_decode_matches_forward(name):
    """The port's counterpart of the JAX package's test of the same name:
    prefill all but the last token, decode the last, against the forward's
    last row (window off, so decode and the forward see the same keys)."""
    cfg, jcfg, jparams, params = _pair(name, sliding_window=None)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (1, 9))
    batch = {"tokens": torch.tensor(toks)}
    if cfg.family == "vlm":
        batch["patches"] = torch.tensor(rng.standard_normal(
            (1, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32))
    full, _ = M.forward(cfg, params, batch)
    pos = toks.shape[1] - 1 + (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
    _, cache = M.prefill(cfg, params, dict(batch, tokens=batch["tokens"][:, :-1]), pos + 8)
    lg, same = M.decode_step(cfg, params, cache, batch["tokens"][:, -1:], torch.tensor([pos]))
    assert same is cache
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(), atol=ATOL_FWD, rtol=0)


def test_decode_steps_match_jax():
    """Ten decode steps of one row from a prefilled cache: logits and the
    whole cache after each step, against the JAX decode step."""
    cfg, jcfg, jparams, params = _pair("gpt-paper")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 7))
    lj, cj = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 32)
    _, ct = M.prefill(cfg, params, {"tokens": torch.tensor(toks)}, 32)
    tok = int(np.argmax(np.asarray(lj)[0, -1]))
    for pos in range(7, 17):
        lgj, cj = JM.decode_step(jcfg, jparams, cj, jnp.asarray([[tok]], jnp.int32),
                                 jnp.int32(pos))
        lgt, ct = M.decode_step(cfg, params, ct, torch.tensor([[tok]]), torch.tensor([pos]))
        np.testing.assert_allclose(lgt.numpy(), np.asarray(lgj), atol=ATOL, rtol=0)
        tok = int(np.argmax(np.asarray(lgj)[0, -1]))
    _leaves_close(ct, cj)


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "list"])
def test_ring_decode_past_the_window(scan_layers):
    """Decode 24 tokens from position 0 through a window of 8 (2 layers):
    the ring wraps at 8, 16; each step's logits equal the JAX decode step's
    and the port's forward with ``window=8`` over the sequence so far."""
    cfg, jcfg, jparams, params = _pair("phi3-mini-3.8b", sliding_window=8,
                                       scan_layers=scan_layers)
    T = 24
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, T))
    full, _ = M.forward(cfg, params, {"tokens": torch.tensor(toks)}, window=8)
    cache = M.init_cache(cfg, 1, 64, device="cpu")
    cj = JM.init_cache(jcfg, 1, 64)
    assert M.cache_width(cfg, 64) == 8
    for t in range(T):
        lgt, cache = M.decode_step(cfg, params, cache, torch.tensor(toks[:, t:t + 1]),
                                   torch.tensor([t]))
        lgj, cj = JM.decode_step(jcfg, jparams, cj, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                 jnp.int32(t))
        np.testing.assert_allclose(lgt.numpy(), np.asarray(lgj), atol=ATOL, rtol=0)
        np.testing.assert_allclose(lgt[0, 0].numpy(), full[0, t].numpy(), atol=ATOL_FWD,
                                   rtol=0)
    _leaves_close(cache, cj)


def test_rows_at_different_positions_decode_as_alone():
    """One batched step with a position per row: two rows prefilled to
    different lengths (one past the window of 8, one inside it) step
    together for 12 waves, each row's logits equal to that row stepped
    alone; the window edge and the ring wrap fall on different waves."""
    cfg, _, _, params = _pair("phi3-mini-3.8b", sliding_window=8)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (11, 3)]
    solo, batch_cache = [], M.init_cache(cfg, 2, 64, device="cpu")
    for b, pr in enumerate(prompts):
        _, c = M.prefill(cfg, params, {"tokens": torch.tensor(pr)}, 64)
        for full, one in zip(jax.tree.leaves(batch_cache), jax.tree.leaves(c)):
            full.select(1, b).copy_(one.select(1, 0))
        solo.append(c)
    nxt = rng.integers(0, cfg.vocab_size, (12, 2))
    pos = torch.tensor([11, 3])
    for w in range(12):
        lg, _ = M.decode_step(cfg, params, batch_cache, torch.tensor(nxt[w])[:, None], pos + w)
        for b in range(2):
            lb, _ = M.decode_step(cfg, params, solo[b], torch.tensor([[nxt[w, b]]]),
                                  torch.tensor([int(pos[b]) + w]))
            np.testing.assert_allclose(lg[b].numpy(), lb[0].numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,part", [("deepseek-v3-671b", "(c)"), ("qwen2-moe-a2.7b", "(c)")])
def test_unported_families_raise_naming_their_item(name, part):
    """Both families of ROADMAP item 10 (c) decode now: MoE (qwen2-moe)
    and MoE with MLA (deepseek-v3, its latent cache).  Their prefill and
    decode step give finite logits of the right shape (held against the
    JAX package's in tests/test_torch_moe_decode.py and
    tests/test_torch_mla_decode.py), as the SSM and hybrid families do
    (tests/test_torch_ssm_decode.py)."""
    cfg = get_config(name).reduced().with_(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    lg, cache = M.prefill(cfg, params, {"tokens": torch.tensor([[3, 5]])}, 8)
    assert lg.shape == (1, 2, cfg.vocab_padded)
    assert set(M._layer_cache(cache, 0)) == ({"ckv", "kr"} if cfg.mla else {"k", "v"})
    lg, _ = M.decode_step(cfg, params, cache, torch.tensor([[7]]), torch.tensor([2]))
    assert lg.shape == (1, 1, cfg.vocab_padded) and bool(torch.isfinite(lg).all())
