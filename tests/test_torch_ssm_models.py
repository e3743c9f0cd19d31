"""Port SSM and hybrid families against the JAX package, on shared weights.

JAX's ``init_params`` weights go to the port through
``repro_torch.interop.params_from_numpy`` in float32: mamba2-1.3b's stacked
tree and recurrentgemma-9b's list of dense and RG-LRU blocks.  Held against
JAX at 2e-4 on the same numpy inputs: ``causal_conv1d``, ``ssm_block`` (y,
final SSD state and conv state), ``_gates``, ``recurrent_block``, and the
``forward`` logits of ``mamba2-1.3b.reduced()`` and of
``recurrentgemma-9b.reduced().with_(n_layers=3)`` (the reduced hybrid has
two RG-LRU layers; the third brings in a local-attention layer).  The
tolerance covers f32 sums in another order (the port's sequential RG-LRU
loop against JAX's associative scan, its SSD kernel op against the jnp
einsums).  The per-block mamba2 forward under a budget keeps the scan as
one ``repro_torch::ssd_scan`` node in the compiled block and equals the
unchunked port (1e-5); so does the hybrid's, with its two block kinds
compiled once each and the RG-LRU scan one ``repro_torch::rglru_scan``
node.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.models import rglru as JRG
from repro.models import ssm as JSSM
from repro_torch.configs import get_config
from repro_torch.core import stats
from repro_torch.core.graph import op_name
from repro_torch.interop import params_from_numpy
from repro_torch.launch import quickstart
from repro_torch.models import model as M
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM

torch.set_num_threads(2)

ATOL = 2e-4
HYBRID_LAYERS = 3


def _pair(arch, dtype="float32", **kw):
    cfg = get_config(arch).reduced().with_(dtype=dtype, **kw)
    jcfg = jax_config(arch).reduced().with_(dtype=dtype, **kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, model, jparams


def _x(shape, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol)


@pytest.fixture(scope="module")
def mamba():
    return _pair("mamba2-1.3b")


@pytest.fixture(scope="module")
def hybrid():
    return _pair("recurrentgemma-9b", n_layers=HYBRID_LAYERS)


def test_params_carry_both_trees():
    """mamba2 keeps its stacked blocks, the hybrid its list of dense and RG
    dicts; in a bf16 model the f32 leaves stay f32."""
    for arch, kw in (("mamba2-1.3b", {}), ("recurrentgemma-9b", {"n_layers": HYBRID_LAYERS})):
        cfg, _, model, jparams = _pair(arch, dtype="bfloat16", **kw)
        jflat = {jax.tree_util.keystr(k, simple=True, separator="."): v
                 for k, v in jax.tree_util.tree_leaves_with_path(jparams)}
        tflat = dict(model.named_parameters())
        assert set(jflat) == set(tflat)
        for name, v in jflat.items():
            assert tuple(tflat[name].shape) == v.shape, name
            assert str(tflat[name].dtype).removeprefix("torch.") == str(v.dtype), name
        f32 = {n for n, t in tflat.items() if t.dtype == torch.float32}
        leaves = {"A_log", "D", "dt_bias"} if arch == "mamba2-1.3b" else {"lam"}
        assert f32 and {n.rsplit(".", 1)[1] for n in f32} == leaves
    # the port's own init has the JAX tree's shapes and dtypes
    for arch, kw in (("mamba2-1.3b", {}), ("recurrentgemma-9b", {"n_layers": HYBRID_LAYERS})):
        cfg, _, model, _ = _pair(arch, dtype="bfloat16", **kw)
        own = M.init_params(cfg, 0, device="cpu")
        assert {n: (t.shape, t.dtype) for n, t in own.named_parameters()} == \
               {n: (t.shape, t.dtype) for n, t in model.named_parameters()}


def test_causal_conv1d(mamba):
    cfg, _, model, jparams = mamba
    w, b = model.layer_params(0)["ssm"]["conv_w"], model.layer_params(0)["ssm"]["conv_b"]
    x, jx = _x((2, 24, w.shape[1]))
    want = JSSM.causal_conv1d(jx, jparams["blocks"]["ssm"]["conv_w"][0],
                              jparams["blocks"]["ssm"]["conv_b"][0])
    _close(SSM.causal_conv1d(x, w, b), want)


def test_ssm_block(mamba):
    cfg, jcfg, model, jparams = mamba
    p = M._index_tree(model["blocks"], 0)["ssm"]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"])["ssm"]
    # 40 tokens: two whole chunks of 16 and a ragged third
    x, jx = _x((2, 40, cfg.d_model), seed=2)
    y, (state, conv_state) = SSM.ssm_block(cfg, p, x)
    jy, (jstate, jconv) = JSSM.ssm_block(jcfg, jp, jx)
    _close(y, jy)
    _close(state, jstate)
    _close(conv_state, jconv)
    with pytest.raises(NotImplementedError, match="decode"):
        SSM.ssm_block(cfg, p, x[:, :1], decode=True)


def test_gates_and_recurrent_block(hybrid):
    cfg, jcfg, model, jparams = hybrid
    assert not cfg.is_attention_layer(0)
    p, jp = model.layer_params(0)["rec"], jparams["blocks"][0]["rec"]
    x, jx = _x((2, 33, cfg.d_model), seed=3)
    for got, want in zip(RG._gates(p, x), JRG._gates(jp, jx)):
        assert got.dtype == torch.float32
        _close(got, want)
    y, (state, conv_state) = RG.recurrent_block(cfg, p, x)
    jy, (jstate, jconv) = JRG.recurrent_block(jcfg, jp, jx)
    _close(y, jy)
    _close(state, jstate)
    _close(conv_state, jconv)
    with pytest.raises(NotImplementedError, match="decode"):
        RG.recurrent_block(cfg, p, x[:, :1], decode=True)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_forward_logits_match_jax(arch, mamba, hybrid):
    cfg, jcfg, model, jparams = mamba if arch == "mamba2-1.3b" else hybrid
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 80))
    got = M.forward(cfg, model, {"tokens": torch.tensor(tokens)})[0]
    want = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})[0]
    assert got.shape == want.shape
    _close(got[..., :cfg.vocab_size], np.asarray(want)[..., :cfg.vocab_size])
    if arch == "recurrentgemma-9b":
        assert [cfg.is_attention_layer(i) for i in range(cfg.n_layers)] == [False, False, True]


def test_per_block_forward_keeps_the_scan_op(mamba):
    """Under a budget each SSM block runs one compiled plan (1 search, the
    other layer replays it), its graph holds the SSD op as one node, and
    the logits equal the unchunked port's."""
    cfg, _, model, _ = mamba
    batch = {"tokens": torch.tensor(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 96)))}
    M._AC_CACHE.clear()
    want = M.forward(cfg, model, batch)[0]
    budget = 0.5
    before = stats.snapshot()
    got = M.forward(cfg.with_(autochunk_budget=budget), model, batch)[0]
    d = stats.delta(before)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    (cf,) = M._AC_CACHE.values()
    assert cf.stats()["compiles"] == 1 and cf.stats()["shape_hits"] == cfg.n_layers - 1
    assert d["plan_bucket_misses"] == 1
    r = cf.autochunk_result
    assert r.plan and r.final_peak < r.baseline_peak
    planned = cf.trace(M._index_tree(model["blocks"], 0),
                       M.embed_inputs(cfg, model, batch)[0]).search()
    scans = [n for n in planned.graph.nodes if op_name(n) == "ssd_scan"]
    assert len(scans) == 1 and scans[0].target is torch.ops.repro_torch.ssd_scan.default
    M._AC_CACHE.clear()


def test_hybrid_under_a_budget_raises(hybrid):
    """The hybrid under a budget runs (it raised before its attention had a
    kernel instance at hd 256): each block kind is compiled once, at its
    first layer, and replayed for the rest of its kind; the RG-LRU block's
    scan stays one ``repro_torch::rglru_scan`` node; the logits equal the
    unchunked port's.  ``tests/test_torch_hybrid_budget.py`` holds the
    same path at hd 256 against the JAX package."""
    cfg, _, model, _ = hybrid
    batch = {"tokens": torch.tensor(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 96)))}
    M._AC_CACHE.clear()
    want = M.forward(cfg, model, batch)[0]
    got = M.forward(cfg.with_(autochunk_budget=0.5), model, batch)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    cfs = {key[2]: cf for key, cf in M._AC_CACHE.items()}
    assert set(cfs) == {"hyb_attn", "hyb_rg"}
    assert cfs["hyb_attn"].stats()["compiles"] == 1 and cfs["hyb_attn"].stats()["shape_hits"] == 0
    assert cfs["hyb_rg"].stats()["compiles"] == 1 and cfs["hyb_rg"].stats()["shape_hits"] == 1
    planned = cfs["hyb_rg"].trace(M._index_tree(model["blocks"][0]),
                                  M.embed_inputs(cfg, model, batch)[0]).search()
    scans = [n for n in planned.graph.nodes if op_name(n) == "rglru_scan"]
    assert len(scans) == 1 and scans[0].target is torch.ops.repro_torch.rglru_scan.default
    M._AC_CACHE.clear()


def test_quickstart_compiles_the_ssm_forward(capsys):
    assert quickstart.main(["--arch", "mamba2-1.3b", "--local", "--device", "cpu",
                            "--seq-len", "256"]) == 0
    out = capsys.readouterr().out
    assert "AutoChunk plan:" in out and "mamba2-1.3b L=2 S=256 float32 on cpu" in out
    assert "max |delta| vs the unchunked forward: 0.000e+00" in out
