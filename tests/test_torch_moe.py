"""Port MoE family against the JAX package's, on shared weights.

qwen2-moe-a2.7b ``reduced()`` in float32, weights from the JAX
``init_params`` carried over by ``repro_torch.interop``.  Held against the
JAX package on the same numpy inputs: ``capacity``; ``route`` (expert
indices, gates and the load-balance aux loss, for the softmax router, the
sigmoid router of ``cfg.mla``, padded experts and tied scores);
``dispatch_tables`` exactly where no expert overflows; ``moe_ffn`` at 1e-5
with ample capacity and at ``capacity_factor`` 0.5 on an input that fills
every expert to its capacity; ``forward``'s logits and aux at 1e-5, stacked,
listed and with a dense first layer.  Where an expert overflows, the port
keeps every assignment ranked below the capacity, as a numpy oracle does;
the JAX package loses each overflowing expert's slot ``cap - 1`` (ROADMAP
C-ref-4), which one test pins.  The per-block forward under a budget
(qwen2's own capacity factor 1.25 and 4 shared experts, B 1, S 1024)
equals the unbudgeted one, its plan within the budget; compiled for the
card, its block dispatches the attention and the shared expert's SwiGLU,
and its routed experts' batched products stay a generic loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.configs import get_config
from repro_torch.core import ChunkConfig, autochunk, stats
from repro_torch.core.dimflow import FULL, propagate
from repro_torch.core.graph import op_name, trace, vshape
from repro_torch.core.lowering import is_chunk_loop
from repro_torch.interop import params_from_numpy
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

torch.set_num_threads(2)

ARCH = "qwen2-moe-a2.7b"
ATOL = 1e-5


def _cfgs(**kw):
    kw = dict(dtype="float32", **kw)
    return get_config(ARCH).reduced().with_(**kw), jax_config(ARCH).reduced().with_(**kw)


def _pair(**kw):
    cfg, jcfg = _cfgs(**kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, model, jparams


def _moe_params(jparams):
    """Layer 0's MoE params, as numpy and as the port's tensors."""
    tree = jax.tree.map(lambda a: np.array(a[0]), jparams["blocks"]["moe"])
    return tree, jax.tree.map(torch.from_numpy, tree)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def test_capacity_matches_jax():
    for n in (1, 16, 64, 1000, 8192):
        for cf in (0.5, 1.25, 8.0):
            cfg, jcfg = _cfgs(capacity_factor=cf)
            assert MOE.capacity(cfg, n) == JMOE.capacity(jcfg, n)
    assert MOE.capacity(get_config(ARCH), 8192) == 640


@pytest.mark.parametrize("case", ["softmax", "sigmoid", "padded", "ties"])
def test_route_matches_jax(case):
    kw = {"sigmoid": dict(mla=True), "padded": dict(n_experts=3)}.get(case, {})
    cfg, jcfg = _cfgs(**kw)
    x = _x((64, cfg.d_model))
    router = _x((cfg.d_model, cfg.n_experts_padded), seed=2) / np.float32(np.sqrt(cfg.d_model))
    if case == "ties":
        router[:] = 0.0      # every score equal: the lower index first
    idx, gates, aux = MOE.route(cfg, torch.from_numpy(x), torch.from_numpy(router))
    jidx, jgates, jaux = JMOE.route(jcfg, jnp.asarray(x), jnp.asarray(router))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), atol=1e-6, rtol=0)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-7)
    if case == "padded":
        assert int(idx.max()) < cfg.n_experts
    if case == "ties":
        assert (idx.numpy() == np.arange(cfg.experts_per_token)).all()


def test_dispatch_tables_match_jax_without_overflow():
    cfg, jcfg = _cfgs()
    S = 64
    router = _x((cfg.d_model, cfg.n_experts_padded), seed=2) / np.float32(np.sqrt(cfg.d_model))
    idx, gates, _ = MOE.route(cfg, torch.from_numpy(_x((S, cfg.d_model))),
                              torch.from_numpy(router))
    cap = MOE.capacity(cfg, S)
    counts = np.bincount(idx.numpy().ravel(), minlength=cfg.n_experts_padded)
    assert counts.max() <= cap                    # ample capacity: nothing dropped
    table, gate_t = MOE.dispatch_tables(cfg, idx[None], gates[None], S, cap)
    jtable, jgate_t = JMOE.dispatch_tables(jcfg, jnp.asarray(idx.numpy()),
                                           jnp.asarray(gates.numpy()), S, cap)
    np.testing.assert_array_equal(table[0].numpy(), np.asarray(jtable))
    np.testing.assert_array_equal(gate_t[0].numpy(), np.asarray(jgate_t))


def _oracle_tables(idx, gates, n_tokens, cap, E):
    """Keep an assignment exactly when its rank (in flat order token * k + j)
    among those to its expert is below ``cap``."""
    table = np.full((E, cap), n_tokens, np.int64)
    gate_t = np.zeros((E, cap), np.float32)
    filled = np.zeros(E, np.int64)
    for t in range(n_tokens):
        for j in range(idx.shape[1]):
            e = idx[t, j]
            if filled[e] < cap:
                table[e, filled[e]], gate_t[e, filled[e]] = t, gates[t, j]
            filled[e] += 1
    return table, gate_t


def test_dispatch_tables_keep_every_rank_below_capacity():
    """16 tokens all routed to experts 0 and 1 at capacity factor 0.5: each
    of the two gets 16 assignments for 8 slots.  The port keeps tokens
    0..7 in both, as the oracle does.  The JAX package's table differs from
    the oracle in exactly one slot of each overflowing expert, ``cap - 1``,
    where a dropped assignment wrote the sentinel and gate 0 (C-ref-4)."""
    cfg, jcfg = _cfgs(capacity_factor=0.5)
    S, E, k = 16, cfg.n_experts_padded, cfg.experts_per_token
    cap = MOE.capacity(cfg, S)
    assert cap == 8
    idx = np.tile(np.arange(k), (S, 1))
    gates = np.random.default_rng(3).uniform(0.1, 1.0, (S, k)).astype(np.float32)
    table, gate_t = MOE.dispatch_tables(cfg, torch.from_numpy(idx[None]),
                                        torch.from_numpy(gates[None]), S, cap)
    want_t, want_g = _oracle_tables(idx, gates, S, cap, E)
    np.testing.assert_array_equal(table[0].numpy(), want_t)
    np.testing.assert_array_equal(gate_t[0].numpy(), want_g)
    assert (want_t[:k] == np.arange(cap)).all()
    jtable, jgate_t = JMOE.dispatch_tables(jcfg, jnp.asarray(idx, jnp.int32),
                                           jnp.asarray(gates), S, cap)
    diff = np.argwhere(np.asarray(jtable) != want_t)
    assert diff.tolist() == [[e, cap - 1] for e in range(k)]
    assert (np.asarray(jtable)[:k, cap - 1] == S).all()
    assert (np.asarray(jgate_t)[:k, cap - 1] == 0).all()


def _filling_input(cfg, S, seed=4):
    """(x, router): tokens 0..S/2-1 pick experts {0, 1}, the rest {2, 3},
    so each of the 4 experts gets S/2 assignments, no more."""
    d = cfg.d_model
    router = np.zeros((d, cfg.n_experts_padded), np.float32)
    router[np.arange(4), np.arange(4)] = 1.0
    x = 0.01 * _x((S, d), seed)
    x[: S // 2, 0], x[: S // 2, 1] = 3.0, 2.0
    x[S // 2:, 2], x[S // 2:, 3] = 3.0, 2.0
    return x, router


@pytest.mark.parametrize("case", ["ample", "filled"])
def test_moe_ffn_matches_jax(case):
    if case == "ample":
        cfg, jcfg, _, jparams = _pair()
        B, S = 2, 32
        xs = _x((B, S, cfg.d_model))
        tree, ours = _moe_params(jparams)
    else:
        # capacity factor 0.5 at 16 tokens: cap 8, and each expert gets 8
        cfg, jcfg, _, jparams = _pair(capacity_factor=0.5)
        B, S = 2, 16
        tree, ours = _moe_params(jparams)
        x, router = _filling_input(cfg, S)
        xs = np.stack([x, x[::-1].copy()])
        tree = dict(tree, router=router)
        ours = dict(ours, router=torch.from_numpy(router))
        assert MOE.capacity(cfg, S) == S * cfg.experts_per_token // cfg.n_experts_padded
    out, aux = MOE.moe_ffn(cfg, ours, torch.from_numpy(xs))
    jout, jaux = JMOE.moe_ffn(jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(xs))
    assert out.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    assert float(aux) == pytest.approx(float(jaux), abs=ATOL)


@pytest.mark.parametrize("kw", [dict(scan_layers=True), dict(scan_layers=False),
                                dict(first_k_dense=1), dict(first_k_dense=1, scan_layers=False)],
                         ids=["stacked", "list", "densepre", "densepre-list"])
def test_forward_matches_jax(kw):
    cfg, jcfg, model, jparams = _pair(**kw)
    assert len(model["dense_blocks"]) == cfg.first_k_dense
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    lg, aux = M.forward(cfg, model, {"tokens": torch.tensor(tokens)})
    jlg, jaux = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    assert lg.shape == (2, 16, cfg.vocab_padded)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL, rtol=0)
    assert float(aux) > 0 and float(aux) == pytest.approx(float(jaux), abs=ATOL)
    # the module call is the same function; layer 0 is the dense block when
    # there is one
    assert torch.equal(model(torch.tensor(tokens))[0], lg)
    p0 = model.layer_params(0)
    names = set(p0) if isinstance(p0, dict) else set(p0._modules)
    assert names - {"ln1", "ln2", "attn"} == ({"mlp"} if cfg.first_k_dense else {"moe"})


# the full config's capacity factor and shared experts, so that at S 1024 the
# routed experts' (E, C, d) output stays below the budget and the shared
# expert's SwiGLU is one of the block's largest values, as at full width
BUDGET_KW = dict(capacity_factor=1.25, n_shared_experts=4)
BUDGET_S = 1024


@pytest.mark.parametrize("budget", [0.5, 0.1])
def test_per_block_forward_matches_unbudgeted(budget):
    cfg = get_config(ARCH).reduced().with_(dtype="float32", **BUDGET_KW)
    model = M.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (1, BUDGET_S)))}
    M._AC_CACHE.clear()
    lg0, aux0 = M.forward(cfg, model, batch)
    cfg_ac = cfg.with_(autochunk_budget=budget)
    lg1, aux1 = M.forward(cfg_ac, model, batch)
    np.testing.assert_allclose(lg1.numpy(), lg0.numpy(), atol=ATOL, rtol=0)
    assert float(aux1) == pytest.approx(float(aux0), abs=1e-6)
    assert list(M._AC_CACHE) == [(cfg.name, budget, "moeNone", cfg_ac)]
    (cf,) = M._AC_CACHE.values()
    assert cf.stats()["compiles"] == 1 and cf.stats()["shape_hits"] == cfg.n_layers - 1
    r = cf.autochunk_result
    assert len(r.plan) > 0 and r.final_peak <= r.budget_bytes < r.baseline_peak
    M._AC_CACHE.clear()


def test_per_block_forward_with_a_dense_first_layer():
    cfg = get_config(ARCH).reduced().with_(dtype="float32", first_k_dense=1, n_layers=3,
                                           **BUDGET_KW)
    model = M.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 256)))}
    M._AC_CACHE.clear()
    lg0, aux0 = M.forward(cfg, model, batch)
    cfg_ac = cfg.with_(autochunk_budget=0.1)
    lg1, aux1 = M.forward(cfg_ac, model, batch)
    np.testing.assert_allclose(lg1.numpy(), lg0.numpy(), atol=ATOL, rtol=0)
    assert float(aux1) == pytest.approx(float(aux0), abs=1e-6)
    tags = [k[2] for k in M._AC_CACHE]
    assert tags == ["densepreNone", "moeNone"]
    assert [cf.stats()["compiles"] for cf in M._AC_CACHE.values()] == [1, 1]
    M._AC_CACHE.clear()


def test_compiled_block_for_the_card_dispatches_attention_and_the_shared_expert():
    """The block compiled for the card at budget 0.1: two dispatch hits,
    the attention (computed mask) and one SwiGLU whose fused weight is the
    shared expert's ``w_in``; the loop over the routed experts' batched
    products is a generic loop (a miss).  The compiled block gives the
    block's output and aux."""
    cfg = get_config(ARCH).reduced().with_(dtype="float32", **BUDGET_KW)
    model = M.init_params(cfg, 0, device="cpu")
    p0 = M._index_tree(model["blocks"], 0)
    x = torch.from_numpy(_x((1, BUDGET_S, cfg.d_model)))

    def block(p, h):
        return M.moe_block_full(cfg, p, h)

    cf = autochunk(block, ChunkConfig.from_scalar(0.1, weight_argnums=(0,), dim_blocklist=(0,),
                                                  kernel_dispatch="on", kernel_target="cuda"))
    before = stats.snapshot()
    planned = cf.trace(p0, x).search()
    d = stats.delta(before)
    assert d["kernel_dispatch_hits"] == 2 and d["kernel_dispatch_computed_mask"] == 1
    assert d["kernel_dispatch_misses"] == 1
    loops = [n for n in planned.graph.nodes if is_chunk_loop(n)]
    kinds = [tuple(r.kind for r in n.params["dispatches"]) for n in loops]
    assert sorted(kinds) == [(), ("attention",), ("swiglu",)]
    (swiglu,) = [r for n in loops for r in n.params["dispatches"] if r.kind == "swiglu"]
    f_shared = cfg.n_shared_experts * cfg.moe_d_ff
    assert (cfg.d_model, 2 * f_shared) in [vshape(v) for v in swiglu.reads]
    (routed,) = [n for n, k in zip(loops, kinds) if not k]
    assert {"bmm", "silu"} <= {op_name(op.node) for op in routed.params["body"]}
    out, aux = planned.compile()(p0, x)
    want, want_aux = block(p0, x)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL, rtol=0)
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-6)


def test_routed_output_bounds_the_block_peak():
    """At ``reduced()``'s capacity factor 8 every expert has 4 S slots, and
    the routed experts' (E, C, d) output is one value of the block: no chunk
    flow crosses the combine (an ``index_add``), so the plan's peak stays at
    or above that value's bytes even where the budget lies below it."""
    cfg = get_config(ARCH).reduced().with_(dtype="float32")
    model = M.init_params(cfg, 0, device="cpu")
    p0 = M._index_tree(model["blocks"], 0)
    x = torch.from_numpy(_x((1, BUDGET_S, cfg.d_model)))
    cf = autochunk(lambda p, h: M.moe_block_full(cfg, p, h),
                   ChunkConfig.from_scalar(0.1, weight_argnums=(0,), dim_blocklist=(0,)))
    r = cf.compile(p0, x).result
    routed = cfg.n_experts_padded * MOE.capacity(cfg, BUDGET_S) * cfg.d_model * 4
    assert len(r.plan) > 0 and r.final_peak < r.baseline_peak
    assert r.budget_bytes < routed <= r.final_peak


def test_index_rule_slices_a_row_gather_by_its_index():
    def gather(x, rows):
        return x[rows] * 2.0

    g, _ = trace(gather, (torch.empty((9, 8), device="meta"),
                          torch.empty((4, 5), dtype=torch.int64, device="meta")),
                 weight_argnums=())
    (node,) = [n for n in g.nodes if op_name(n) == "index"]
    x, rows = g.invars
    assert vshape(node) == (4, 5, 8)
    assert propagate(node, 1) == {rows: 1, x: FULL}
    assert propagate(node, 2) == {x: 1, rows: FULL}


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "list"])
@pytest.mark.parametrize("first_k_dense", [0, 1])
def test_init_params_on_meta_match_jax_shapes(scan_layers, first_k_dense):
    cfg, jcfg = _cfgs(scan_layers=scan_layers, first_k_dense=first_k_dense)
    cfg, jcfg = cfg.with_(dtype="bfloat16"), jcfg.with_(dtype="bfloat16")
    ours = dict(M.init_params(cfg, device="meta").named_parameters())
    theirs = {}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}.")
        else:
            theirs[prefix[:-1]] = tree
    walk(JM.param_specs(jcfg))
    assert set(ours) == set(theirs)
    for k, v in ours.items():
        assert tuple(v.shape) == theirs[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(theirs[k].dtype), k
    assert ours[("blocks.moe.router" if scan_layers else "blocks.0.moe.router")].dtype \
        == torch.float32


def test_full_width_weight_bytes():
    """qwen2-moe-a2.7b's bf16 weights at full width, as the card run sizes
    them: per MoE layer 1,107,296,256 B of routed experts, 69,206,016 of
    shared expert, 33,554,432 of attention and 524,288 of router."""
    cfg = get_config(ARCH).with_(scan_layers=False)
    model = M.init_params(cfg, device="meta")
    p = model.layer_params(0)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree.parameters())

    moe = p["moe"]
    assert moe["w_up"].numel() * 2 + moe["w_down"].numel() * 2 == 1_107_296_256
    assert nbytes(moe["shared"]) == 69_206_016
    assert nbytes(p["attn"]) == 33_554_432
    assert moe["router"].numel() * 4 == 524_288
    assert len(model["blocks"]) == cfg.n_layers == 24


@pytest.mark.parametrize("what", ["init_params", "forward"])
def test_mla_still_raises_naming_its_item(what):
    """MLA's forward is ported (tests/test_torch_mla.py holds it against the
    JAX package): reduced deepseek-v3 builds, with its MLA and MTP params,
    and its forward gives finite logits of the right shape.  Its decode is
    ported too (tests/test_torch_mla_decode.py): one step against the
    latent ring gives finite logits of the right shape."""
    cfg = get_config("deepseek-v3-671b").reduced()
    model = M.init_params(cfg, 0, device="cpu")
    if what == "init_params":
        attn = model.layer_params(0)["attn"]
        assert attn["w_uk"].shape == (cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_dim)
        assert model["mtp_proj"].shape == (2 * cfg.d_model, cfg.d_model)
        assert all(p.dtype == torch.bfloat16 for n, p in model.named_parameters()
                   if not n.endswith("moe.router"))
    else:
        lg, aux = M.forward(cfg, model, {"tokens": torch.zeros((1, 2), dtype=torch.int64)})
        assert lg.shape == (1, 2, cfg.vocab_padded) and bool(torch.isfinite(lg).all())
        assert bool(torch.isfinite(aux))
    cache = M.init_cache(cfg, 1, 8, device="cpu")
    lg, same = M.decode_step(cfg, model, cache, torch.zeros((1, 1), dtype=torch.int64), 0)
    assert same is cache and lg.shape == (1, 1, cfg.vocab_padded)
    assert bool(torch.isfinite(lg).all()) and float(cache["moe_layers"]["ckv"].abs().max()) > 0
