"""Per-block AutoChunk inside the port's ``forward`` against the JAX package's.

``forward(cfg.with_(autochunk_budget=b))`` compiles one dense block through
the AutoChunk pipeline at the first layer and replays it for every other
layer.  Held against the port's forward without a budget (1e-5) and JAX's
``forward`` with the same budget (generic scan codegen; 2e-4) on weights
carried over by ``repro_torch.interop``: gpt-paper ``reduced()`` f32 at
B 2, S 64 (the case of ``tests/test_system.py``) and minitron-4b
``reduced()`` f32 at B 1, S 256, budget 0.04, where the block's plan
chunks the SwiGLU MLP.  On this host ``kernel_dispatch="auto"`` is off; a
reduced minitron block compiled with ``kernel_dispatch="on"`` dispatches
both its attention and its SwiGLU (plain kernels on CPU tensors) and keeps
its output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.core import ChunkConfig, ChunkedFunction, autochunk, stats
from repro_torch.core.graph import op_name
from repro_torch.core.lowering import is_chunk_loop
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import chunked_attention as CA
from repro_torch.models import model as M

torch.set_num_threads(2)

CASES = {
    "gpt-paper": dict(B=2, S=64, budget=0.3),
    "minitron-4b": dict(B=1, S=256, budget=0.04),
}


def _pair(arch):
    kw = dict(dtype="float32")
    cfg = get_config(arch).reduced().with_(**kw)
    jcfg = jax_config(arch).reduced().with_(**kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    c = CASES[arch]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (c["B"], c["S"]))
    return cfg, jcfg, model, jparams, tokens


@pytest.mark.parametrize("arch", list(CASES))
def test_forward_with_budget_matches_unchunked_and_jax(arch):
    cfg, jcfg, model, jparams, tokens = _pair(arch)
    budget = CASES[arch]["budget"]
    M._AC_CACHE.clear()
    batch = {"tokens": torch.tensor(tokens)}
    lg0 = M.forward(cfg, model, batch)[0]
    before = stats.snapshot()
    lg1 = M.forward(cfg.with_(autochunk_budget=budget), model, batch)[0]
    d = stats.delta(before)
    np.testing.assert_allclose(lg1.numpy(), lg0.numpy(), atol=1e-5)
    jlg = JM.forward(jcfg.with_(autochunk_budget=budget), jparams,
                     {"tokens": jnp.asarray(tokens, jnp.int32)})[0]
    np.testing.assert_allclose(lg1.numpy(), np.asarray(jlg), atol=2e-4)

    # the cache is keyed as in the JAX package, and one search served every layer
    key = (cfg.name, budget, "denseNone", cfg.with_(autochunk_budget=budget))
    assert list(M._AC_CACHE) == [key]
    cf = M._AC_CACHE[key]
    assert isinstance(cf, ChunkedFunction)
    assert cf.stats()["compiles"] == 1 and cf.stats()["shape_hits"] == cfg.n_layers - 1
    assert d["plan_bucket_misses"] == 1 and d["search_passes"] >= 1
    r = cf.autochunk_result
    assert r is not None and r.plan and r.final_peak < r.baseline_peak

    # search passes of the whole forward == those of one block compile
    p0 = M._index_tree(model["blocks"], 0)
    h0, _ = M.embed_inputs(cfg, model, batch)
    fresh = autochunk(cf.fn, cf.config)
    before = stats.snapshot()
    fresh.compile(p0, h0)
    assert stats.delta(before)["search_passes"] == d["search_passes"]


def test_minitron_block_plan_chunks_the_mlp():
    """At B 1, S 256, budget 0.04 the block's plan puts the SwiGLU in a chunk
    loop, which is what puts ``chunked_ffn`` on the main path on the card."""
    cfg, _, model, _, tokens = _pair("minitron-4b")
    M._AC_CACHE.clear()
    batch = {"tokens": torch.tensor(tokens)}
    M.forward(cfg.with_(autochunk_budget=0.04), model, batch)
    (cf,) = M._AC_CACHE.values()
    # the same shape again replays the bucket's plan: its rewritten graph
    before = stats.snapshot()
    planned = cf.trace(M._index_tree(model["blocks"], 0), M.embed_inputs(cfg, model, batch)[0]
                       ).search()
    assert planned.bucket_hit and stats.delta(before)["search_passes"] == 0
    loops = [n for n in planned.graph.nodes if is_chunk_loop(n)]
    assert any(op_name(op.node) == "silu" for n in loops for op in n.params["body"])


def test_forward_without_budget_is_unchanged():
    cfg, _, model, _, tokens = _pair("gpt-paper")
    M._AC_CACHE.clear()
    batch = {"tokens": torch.tensor(tokens)}
    lg = M.forward(cfg, model, batch)[0]
    h, pos = M.embed_inputs(cfg, model, batch)
    for i in range(cfg.n_layers):
        h = M.dense_block_full(cfg, model.layer_params(i), h, pos)
    from repro_torch.models import layers as L
    want = L.unembed(cfg, model["embed"], L.apply_norm(cfg, h, model["final_norm"]))
    assert torch.equal(lg, want) and not M._AC_CACHE


def test_list_form_params_take_the_same_path():
    """``scan_layers=False`` (a list of blocks) runs the same per-block plan."""
    cfg, _, model, _, tokens = _pair("minitron-4b")
    cfg_l = cfg.with_(scan_layers=False)
    model_l = M.init_params(cfg_l, 0, device="cpu")
    for i in range(cfg.n_layers):
        for name, t in M._index_tree(model["blocks"], i).items():
            if isinstance(t, dict):
                for k, v in t.items():
                    model_l["blocks"][i][name][k].copy_(v)
            else:
                model_l["blocks"][i][name].copy_(t)
    for name in ("embed", "final_norm"):
        for k, v in M._index_tree(model[name]).items():
            model_l[name][k].copy_(v)
    M._AC_CACHE.clear()
    batch = {"tokens": torch.tensor(tokens)}
    want = M.forward(cfg.with_(autochunk_budget=0.04), model, batch)[0]
    got = M.forward(cfg_l.with_(autochunk_budget=0.04), model_l, batch)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_reduced_minitron_block_dispatches_attention_and_swiglu():
    cfg, _, model, _, tokens = _pair("minitron-4b")
    batch = {"tokens": torch.tensor(tokens)}
    p0 = M._index_tree(model["blocks"], 0)
    h0, _ = M.embed_inputs(cfg, model, batch)

    def block(p, x):
        return M.dense_block_full(cfg, p, x, causal=cfg.causal)

    cf = autochunk(block, ChunkConfig.from_scalar(0.04, weight_argnums=(0,),
                                                  dim_blocklist=(0,), kernel_dispatch="on"))
    before = stats.snapshot()
    compiled = cf.compile(p0, h0)
    d = stats.delta(before)
    # one attention (computed mask) and one SwiGLU site
    assert d["kernel_dispatch_hits"] == 2 and d["kernel_dispatch_computed_mask"] == 1
    assert d["kernel_dispatch_misses"] == 0
    np.testing.assert_allclose(compiled(p0, h0).numpy(), block(p0, h0).numpy(), atol=1e-5)



def test_bf16_block_attention_reads_rounded_bf16_operands(monkeypatch):
    """In bf16 the dispatched attention reads the values the program reads:
    K after RoPE's cast to bf16 (not the f32 values before it), V, and each
    chunk of q in bf16 (the loop slices an f32 copy of the bf16 q, read back
    exactly).  Every operand equals the eager projection's, bit for bit."""
    cfg = get_config("minitron-4b").reduced().with_(dtype="bfloat16")
    model = M.init_params(cfg, 0, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 256))
    p0 = M._index_tree(model["blocks"], 0)
    x, pos = M.embed_inputs(cfg, model, {"tokens": torch.tensor(tokens)})
    seen = []
    fn = CA.computed_attention

    def spy(q, k, v, q_offset, **kw):
        seen.append((q.clone(), k.clone(), v.clone(), q_offset))
        return fn(q, k, v, q_offset, **kw)

    monkeypatch.setattr(CA, "computed_attention", spy)

    def block(p, h):
        return M.dense_block_full(cfg, p, h, causal=cfg.causal)

    cf = autochunk(block, ChunkConfig.from_scalar(0.04, weight_argnums=(0,), dim_blocklist=(0,),
                                                  kernel_dispatch="on"))
    cf.compile(p0, x)(p0, x)
    from repro_torch.models import layers as L
    q, k, v = L.attn_project_qkv(cfg, p0["attn"], L.apply_norm(cfg, x, p0["ln1"]), pos)
    S, Kv, H = x.shape[1], cfg.n_kv_heads, cfg.n_heads
    q_heads = q[0].reshape(S, Kv, H // Kv, cfg.hd).permute(1, 2, 0, 3).reshape(H, S, cfg.hd)
    assert len(seen) >= 2
    for qc, kc, vc, off in seen:
        assert qc.dtype == kc.dtype == vc.dtype == torch.bfloat16
        assert torch.equal(kc, k[0].transpose(0, 1)) and torch.equal(vc, v[0].transpose(0, 1))
        assert torch.equal(qc, q_heads[:, off:off + qc.shape[1]])
