"""Port MLA forward (deepseek-v3) against the JAX package's, on shared weights.

deepseek-v3-671b ``reduced()`` in float32 (a dense first layer, then a MoE
layer with sigmoid routing; MLA at q_lora 64, kv_lora 32, qk_nope 16,
qk_rope 16, v 16), weights from the JAX ``init_params`` carried over by
``repro_torch.interop``.  Held against the JAX package on the same numpy
inputs: ``mla_latent``, ``mla_queries`` and ``mla_attention_prefill``
(window None and 8) at 1e-5; ``forward``'s logits at 1e-4 and aux at 1e-6,
stacked and listed; ``mtp_logits`` on the same ``h_final`` at 1e-4.

The per-block forward (budgets 0.5 and 0.1, capacity factor 1.25, S 512)
equals the port's unbudgeted forward within 1e-3 and the JAX forward within
1e-3 at every position but the ones the reference loses: at this capacity
an expert of the MoE layer overflows, and the JAX table drops the token at
its slot ``cap - 1`` (ROADMAP C-ref-4), which the port keeps.  The MoE
layer is the last, so that token's logits are the only ones it changes.
The dense-prefix block's plan ends below its baseline in both packages.

Compiled for the card, MLA's scores (a sum of two products) dispatch no
attention kernel: the site stays a generic loop, while the dense MLP's and
the shared expert's SwiGLU dispatch onto ``chunked_ffn``.  The full
configuration's weight bytes on ``meta`` and ``params_from_numpy``'s
carrying of the MLA and MTP leaves are pinned too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import mla as JMLA
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.core import ChunkConfig, autochunk, stats
from repro_torch.core.graph import vshape
from repro_torch.core.lowering import is_chunk_loop
from repro_torch.interop import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
ATOL = 1e-5
ATOL_FWD = 1e-4
ATOL_BUDGET = 1e-3


def _cfgs(**kw):
    kw = dict(dtype="float32", **kw)
    return get_config(ARCH).reduced().with_(**kw), jax_config(ARCH).reduced().with_(**kw)


def _pair(**kw):
    cfg, jcfg = _cfgs(**kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, model, jparams


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("fn", ["latent", "queries", "prefill-None", "prefill-8"])
def test_mla_functions_match_jax(fn):
    cfg, jcfg, _, jparams = _pair(scan_layers=False)
    tree = jax.tree.map(np.array, jparams["dense_blocks"][0]["attn"])
    ours = {k: torch.from_numpy(v) for k, v in tree.items()}
    B, S = 2, 16
    x = _x((B, S, cfg.d_model))
    pos = np.arange(S, dtype=np.int32)
    args = (torch.from_numpy(x), torch.from_numpy(pos))
    jargs = (jnp.asarray(x), jnp.asarray(pos))
    if fn == "latent":
        got, want = MLA.mla_latent(cfg, ours, *args), JMLA.mla_latent(jcfg, tree, *jargs)
        shapes = [(B, S, cfg.kv_lora_rank), (B, S, cfg.qk_rope_dim)]
    elif fn == "queries":
        got, want = MLA.mla_queries(cfg, ours, *args), JMLA.mla_queries(jcfg, tree, *jargs)
        shapes = [(B, S, cfg.n_heads, cfg.qk_nope_dim), (B, S, cfg.n_heads, cfg.qk_rope_dim)]
    else:
        window = None if fn == "prefill-None" else int(fn.split("-")[1])
        (o, lat) = MLA.mla_attention_prefill(cfg, ours, *args, window=window)
        (jo, jlat) = JMLA.mla_attention_prefill(jcfg, tree, *jargs, window=window)
        got, want = (o,) + lat, (jo,) + jlat
        shapes = [(B, S, cfg.d_model), (B, S, cfg.kv_lora_rank), (B, S, cfg.qk_rope_dim)]
    assert [tuple(t.shape) for t in got] == shapes
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_a_window_changes_the_attention():
    """Window 8 at S 16 masks keys the causal attention sees."""
    cfg, _, model, _ = _pair(scan_layers=False)
    p = M._index_tree(model["dense_blocks"][0]["attn"])
    x = torch.from_numpy(_x((1, 16, cfg.d_model)))
    pos = torch.arange(16, dtype=torch.int32)
    full = MLA.mla_attention_prefill(cfg, p, x, pos)[0]
    win = MLA.mla_attention_prefill(cfg, p, x, pos, window=8)[0]
    assert torch.equal(full[:, :8], win[:, :8])
    assert float((full[:, 8:] - win[:, 8:]).abs().max()) > 1e-3


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "list"])
def test_forward_matches_jax(scan_layers):
    cfg, jcfg, model, jparams = _pair(scan_layers=scan_layers)
    assert cfg.mla and cfg.mtp and cfg.first_k_dense == 1
    tokens = _tokens(cfg, (2, 16))
    lg, aux = M.forward(cfg, model, {"tokens": torch.tensor(tokens)})
    jlg, jaux = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    assert lg.shape == (2, 16, cfg.vocab_padded)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL_FWD, rtol=0)
    assert float(aux) > 0 and float(aux) == pytest.approx(float(jaux), abs=1e-6)
    assert torch.equal(model(torch.tensor(tokens))[0], lg)


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "list"])
def test_mtp_logits_match_jax(scan_layers):
    cfg, jcfg, model, jparams = _pair(scan_layers=scan_layers)
    B, S = 2, 16
    tokens = _tokens(cfg, (B, S))
    h_final = _x((B, S, cfg.d_model), seed=3)
    got = M.mtp_logits(cfg, model, {"tokens": torch.tensor(tokens)}, torch.from_numpy(h_final))
    want = JM.mtp_logits(jcfg, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                         jnp.asarray(h_final))
    assert got.shape == (B, S - 1, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_FWD, rtol=0)


# the full config's capacity factor: at S 512 an expert overflows, as the
# full model's do at S 8192, and the routed (E, C, d) output stays below
# the budget
BUDGET_KW = dict(capacity_factor=1.25)
BUDGET_S = 512


def _lost_tokens(cfg, model, tokens):
    """Tokens of the last (MoE) layer that the reference's table loses:
    for each expert over capacity, the token of its assignment ranked
    ``cap - 1`` (flat order token * k + j), as ``MOE.dispatch_tables``
    ranks them (ROADMAP C-ref-4)."""
    h, _ = M.embed_inputs(cfg, model, {"tokens": torch.tensor(tokens)})
    for i in range(cfg.n_layers - 1):
        p = model.layer_params(i)
        h = (M.dense_block_full(cfg, p, h) if i < cfg.first_k_dense
             else M.moe_block_full(cfg, p, h)[0])
    p = model.layer_params(cfg.n_layers - 1)
    x = M.attn_apply_full(cfg, p, h, None, window=None, causal=True)
    idx = MOE.route(cfg, L.apply_norm(cfg, x, p["ln2"]).reshape(-1, cfg.d_model),
                    p["moe"]["router"])[0].numpy()
    cap, k = MOE.capacity(cfg, tokens.shape[1]), cfg.experts_per_token
    flat = idx.reshape(-1)
    return sorted({int(np.flatnonzero(flat == e)[cap - 1]) // k
                   for e in range(cfg.n_experts) if (flat == e).sum() > cap})


@pytest.mark.parametrize("budget", [0.5, 0.1])
def test_per_block_forward_matches_unbudgeted_and_jax(budget):
    cfg, jcfg, model, jparams = _pair(**BUDGET_KW)
    tokens = _tokens(cfg, (1, BUDGET_S), seed=1)
    batch, jbatch = {"tokens": torch.tensor(tokens)}, {"tokens": jnp.asarray(tokens, jnp.int32)}
    M._AC_CACHE.clear()
    JM._AC_CACHE.clear()
    lg0, aux0 = M.forward(cfg, model, batch)
    lg1, aux1 = M.forward(cfg.with_(autochunk_budget=budget), model, batch)
    jlg, jaux = JM.forward(jcfg, jparams, jbatch)
    JM.forward(jcfg.with_(autochunk_budget=budget), jparams, jbatch)
    np.testing.assert_allclose(lg1.numpy(), lg0.numpy(), atol=ATOL_BUDGET, rtol=0)
    assert float(aux1) == pytest.approx(float(aux0), abs=1e-6)

    lost = _lost_tokens(cfg, model, tokens)
    assert lost, "no expert overflows at this capacity"
    err = np.abs(lg1.numpy() - np.asarray(jlg)).max(axis=(0, 2))
    kept = np.setdiff1d(np.arange(BUDGET_S), lost)
    assert err[kept].max() <= ATOL_BUDGET
    assert (err[lost] > ATOL_BUDGET).all()
    assert float(aux1) == pytest.approx(float(jaux), abs=1e-6)

    ours = {key[2]: cf for key, cf in M._AC_CACHE.items()}
    ref = {key[2]: cf for key, cf in JM._AC_CACHE.items()}
    assert set(ours) == set(ref) == {"densepreNone", "moeNone"}
    assert all(cf.stats()["compiles"] == 1 for cf in ours.values())
    for plans in (ours, ref):
        r = plans["densepreNone"].autochunk_result
        assert len(r.plan) > 0 and r.final_peak < r.baseline_peak
    M._AC_CACHE.clear()
    JM._AC_CACHE.clear()


# S 2048 and a shared expert of f 256: the scores are the block's largest
# values, as at full width, and after they are chunked the dense MLP and
# the shared expert's SwiGLU still lie above the budget
CARD_KW = dict(capacity_factor=1.25, moe_d_ff=256)
CARD_S = 2048
CARD_BUDGET = 0.02


@pytest.mark.parametrize("layer", [0, 1], ids=["densepre", "moe"])
def test_block_compiled_for_the_card_leaves_the_mla_scores_generic(layer):
    """Dispatch finds no attention site in an MLA block: its scores are the
    sum of two products, which no attention kernel computes.  The scores
    loop stays generic (a miss); the SwiGLU (the dense MLP, or the MoE
    block's shared expert) dispatches onto ``chunked_ffn``; the MoE block's
    routed experts stay a generic loop.  The compiled block gives the
    block's output (and aux)."""
    cfg = get_config(ARCH).reduced().with_(dtype="float32", **CARD_KW)
    model = M.init_params(cfg, 0, device="cpu")
    p = model.layer_params(layer)
    p = p if isinstance(p, dict) else M._index_tree(p)
    x = torch.from_numpy(_x((1, CARD_S, cfg.d_model)))
    dense = layer < cfg.first_k_dense

    def block(p, h):
        return M.dense_block_full(cfg, p, h) if dense else M.moe_block_full(cfg, p, h)

    cf = autochunk(block, ChunkConfig.from_scalar(CARD_BUDGET, weight_argnums=(0,),
                                                  dim_blocklist=(0,), kernel_dispatch="on",
                                                  kernel_target="cuda"))
    before = stats.snapshot()
    planned = cf.trace(p, x).search()
    d = stats.delta(before)
    loops = [n for n in planned.graph.nodes if is_chunk_loop(n)]
    kinds = [tuple(r.kind for r in n.params["dispatches"]) for n in loops]
    assert d["kernel_dispatch_hits"] == 1 and d["kernel_dispatch_computed_mask"] == 0
    assert d["kernel_dispatch_misses"] == (1 if dense else 2)
    assert sorted(kinds) == ([(), ("swiglu",)] if dense else [(), (), ("swiglu",)])
    (swiglu,) = [r for n in loops for r in n.params["dispatches"]]
    f = cfg.d_ff if dense else cfg.n_shared_experts * cfg.moe_d_ff
    assert (cfg.d_model, 2 * f) in [vshape(v) for v in swiglu.reads]
    out = planned.compile()(p, x)
    want = block(p, x)
    if dense:
        out, want = (out,), (want,)
    np.testing.assert_allclose(out[0].numpy(), want[0].numpy(), atol=ATOL, rtol=0)
    if not dense:
        assert float(out[1]) == pytest.approx(float(want[1]), abs=1e-6)


# bf16 bytes of deepseek-v3 at full width, as the card run builds it (the
# list form), by part
DENSE_ATTN, DENSE_MLP = 374_214_656, 792_723_456
DENSE_BLOCK = 1_166_966_784
MOE_BLOCK = 23_018_242_048
ROUTED_UP, ROUTED_DOWN, SHARED, ROUTER = 15_032_385_536, 7_516_192_768, 88_080_384, 7_340_032
EMBED = 3_706_716_160
MTP_PROJ = 205_520_896
TOTAL = {4: 31_598_374_912, 5: 54_616_616_960}


def _nbytes(tree):
    ts = tree.parameters() if hasattr(tree, "parameters") else [tree]
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("n_layers", [4, 5])
def test_full_width_weight_bytes(n_layers):
    cfg = get_config(ARCH).with_(scan_layers=False, n_layers=n_layers)
    model = M.init_params(cfg, device="meta")
    assert len(model["dense_blocks"]) == 3 and len(model["blocks"]) == n_layers - 3
    dense, moe = model.layer_params(0), model.layer_params(3)
    assert (_nbytes(dense["attn"]), _nbytes(dense["mlp"])) == (DENSE_ATTN, DENSE_MLP)
    assert _nbytes(dense) == DENSE_BLOCK and _nbytes(moe) == MOE_BLOCK
    assert _nbytes(moe["attn"]) == DENSE_ATTN
    m = moe["moe"]
    assert (_nbytes(m["w_up"]), _nbytes(m["w_down"]), _nbytes(m["shared"]),
            _nbytes(m["router"])) == (ROUTED_UP, ROUTED_DOWN, SHARED, ROUTER)
    assert m["router"].dtype == torch.float32
    assert _nbytes(model["embed"]) == EMBED
    assert _nbytes(model["mtp_proj"]) == MTP_PROJ
    assert _nbytes(model["mtp_block"]) == DENSE_BLOCK
    assert _nbytes(model) == TOTAL[n_layers]


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "list"])
def test_params_from_numpy_carries_the_mla_and_mtp_leaves(scan_layers):
    """Every leaf of the JAX tree (bf16, as the config makes it) arrives
    bit for bit under its own path, the MLA and MTP leaves among them; the
    port's own ``init_params`` on ``meta`` has the same paths, shapes and
    dtypes."""
    cfg = get_config(ARCH).reduced().with_(scan_layers=scan_layers)
    jcfg = jax_config(ARCH).reduced().with_(scan_layers=scan_layers)
    assert cfg.dtype == "bfloat16"
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    model = params_from_numpy(cfg, tree, device="cpu")
    ours = dict(model.named_parameters())
    theirs = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    assert set(ours) == set(theirs)
    mla = {k for k in ours if ".attn." in k}
    assert {k.rsplit(".", 1)[1] for k in mla} == {"w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm",
                                                  "w_uk", "w_uv", "w_kr", "w_o"}
    assert {k for k in ours if k.startswith("mtp_")} >= {"mtp_proj", "mtp_norm.w",
                                                        "mtp_block.attn.w_uk"}
    for k, t in ours.items():
        want = theirs[k]
        assert tuple(t.shape) == want.shape, k
        assert str(t.dtype).removeprefix("torch.") == str(want.dtype), k
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)
    meta = dict(M.init_params(cfg, device="meta").named_parameters())
    assert {k: (tuple(v.shape), v.dtype) for k, v in meta.items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in ours.items()}
