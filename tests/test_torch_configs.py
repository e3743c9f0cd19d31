"""The port's config registry equals the JAX package's, field for field."""
import dataclasses

import pytest
import torch

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.configs import REGISTRY as JAX_REGISTRY
from repro_torch.configs import ASSIGNED, INPUT_SHAPES, REGISTRY, get_config

torch.set_num_threads(2)


def test_registry_names_and_order():
    assert list(REGISTRY) == list(JAX_REGISTRY)
    assert ASSIGNED == JAX_ASSIGNED
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_INPUT_SHAPES.items()}
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_config_and_reduced_match_jax(name):
    jcfg = JAX_REGISTRY[name]
    cfg = get_config(name)
    for ours, theirs in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert (ours.hd, ours.vocab_padded, ours.d_inner, ours.ssm_heads) == (
            theirs.hd, theirs.vocab_padded, theirs.d_inner, theirs.ssm_heads)
        assert str(ours.torch_dtype) == f"torch.{theirs.jdtype.name}"
        assert ours.supports_decode() == theirs.supports_decode()
        assert ours.supports_long_context() == theirs.supports_long_context()
        assert [ours.is_attention_layer(i) for i in range(ours.n_layers)] == [
            theirs.is_attention_layer(i) for i in range(theirs.n_layers)]
