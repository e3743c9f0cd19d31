"""The hybrid family under a budget against the JAX package's.

recurrentgemma-9b reduced to 3 layers (two RG-LRU, one local attention) at
a narrow d_model but its own head dim of 256, float32, on JAX's
``init_params`` weights carried over by ``repro_torch.interop``.  With
``autochunk_budget`` each package compiles one plan for the attention block
(tag ``hyb_attn``) and one for the RG-LRU block (``hyb_rg``), each at the
first layer of its kind.  Held: the port's logits against JAX's forward
under the same budget (1e-5; the unbudgeted forwards differ by 7e-6 here,
the port's sequential RG-LRU against JAX's associative scan) and against
the port's unbudgeted forward (1e-5); every stage of both packages' plans
chunks the token axis; and the stage counts of both, pinned.  The port's
plans have more stages than the reference's because the reference cannot
chunk through a GeGLU MLP (``jnp.split`` of ``w_in`` is one ``split``
primitive, for which its dimflow has no rule: ROADMAP C-ref-1), while the
port can; so the port's RG-LRU block is chunked where the reference's is
not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import model as M

torch.set_num_threads(2)

S = 256
BUDGET = 0.5
SHAPE = dict(dtype="float32", n_layers=3, head_dim=256)
# (port, reference) stages of each block's plan at S 256, budget 0.5
STAGES = {"hyb_attn": (3, 2), "hyb_rg": (1, 0)}


def test_hybrid_under_a_budget_matches_jax():
    cfg = get_config("recurrentgemma-9b").reduced().with_(**SHAPE)
    jcfg = jax_config("recurrentgemma-9b").reduced().with_(**SHAPE)
    assert cfg.hd == 256 and cfg.n_kv_heads == 1
    assert [cfg.is_attention_layer(i) for i in range(3)] == [False, False, True]
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, S))
    V = cfg.vocab_size

    M._AC_CACHE.clear()
    JM._AC_CACHE.clear()
    want = M.forward(cfg, model, {"tokens": torch.tensor(tokens)})[0][..., :V].numpy()
    got = M.forward(cfg.with_(autochunk_budget=BUDGET), model,
                    {"tokens": torch.tensor(tokens)})[0][..., :V].numpy()
    theirs = np.asarray(JM.forward(jcfg.with_(autochunk_budget=BUDGET), jparams,
                                   {"tokens": jnp.asarray(tokens, jnp.int32)})[0])[..., :V]
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, theirs, atol=1e-5)

    ours = {key[2]: cf for key, cf in M._AC_CACHE.items()}
    ref = {key[2]: cf for key, cf in JM._AC_CACHE.items()}
    assert set(ours) == set(ref) == set(STAGES)
    assert ours["hyb_attn"].stats()["compiles"] == 1
    assert ours["hyb_rg"].stats()["compiles"] == 1 and ours["hyb_rg"].stats()["shape_hits"] == 1
    for tag, (n_ours, n_ref) in STAGES.items():
        r, jr = ours[tag].autochunk_result, ref[tag].autochunk_result
        assert (len(r.plan), len(jr.plan)) == (n_ours, n_ref), tag
        assert all(s.chunk_extent == S for s in r.plan + jr.plan), tag
        assert r.final_peak < r.baseline_peak
    M._AC_CACHE.clear()
    JM._AC_CACHE.clear()
