"""Port dense forward against ``repro.models.model.forward``.

Both configs ``reduced()`` in float32, weights from the JAX ``init_params``
carried over by ``repro_torch.interop``; logits agree to atol 1e-4.
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


def _pair(name, scan_layers):
    cfg = get_config(name).reduced().with_(dtype="float32", scan_layers=scan_layers)
    jcfg = jax_config(name).reduced().with_(dtype="float32", scan_layers=scan_layers)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, jparams, params_from_numpy(cfg, tree, device="cpu")


def _jax_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _jax_paths(v, f"{prefix}{k}.")}
    if isinstance(tree, list):
        return {p for i, v in enumerate(tree) for p in _jax_paths(v, f"{prefix}{i}.")}
    return {prefix[:-1]}


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "list"])
@pytest.mark.parametrize("name", ["gpt-paper", "minitron-4b"])
def test_forward_matches_jax(name, scan_layers):
    cfg, jcfg, jparams, params = _pair(name, scan_layers)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    ours, aux = M.forward(cfg, params, {"tokens": torch.tensor(tokens)})
    theirs, jaux = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    assert ours.shape == theirs.shape == (2, 12, cfg.vocab_padded)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4, rtol=0)
    assert float(aux) == float(jaux) == 0.0
    # the nn.Module call is the same function
    np.testing.assert_array_equal(params(torch.tensor(tokens))[0].numpy(), ours.numpy())


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "list"])
def test_state_dict_keys_follow_jax_paths(scan_layers):
    cfg, jcfg, jparams, params = _pair("gpt-paper", scan_layers)
    assert set(params.state_dict()) == _jax_paths(jparams)
    key = "blocks.attn.wq" if scan_layers else "blocks.0.attn.wq"
    assert key in params.state_dict()


@pytest.mark.parametrize("name", ["gpt-paper", "minitron-4b"])
def test_init_params_shapes_and_scale_match_jax(name):
    cfg = get_config(name).reduced()
    jcfg = jax_config(name).reduced()
    ours = M.init_params(cfg, 0, device="cpu")
    theirs = JM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = dict(ours.state_dict())
    jflat = {}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.")
        else:
            jflat[prefix[:-1]] = tree
    walk(theirs)
    assert set(flat) == set(jflat)
    for k, v in flat.items():
        jv = jflat[k]
        assert tuple(v.shape) == jv.shape and v.dtype == torch.bfloat16
        # same distribution: N(0, s^2) weights, constant norm params
        assert float(v.float().std()) == pytest.approx(float(np.asarray(jv, np.float32).std()),
                                                       rel=0.1, abs=1e-6), k
    # a torch.Generator seeds it: same seed, same numbers
    again = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for k, v in again.state_dict().items():
        assert torch.equal(v, flat[k])


def test_init_params_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(get_config("gpt-paper").reduced())
