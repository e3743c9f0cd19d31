"""The port's synthetic data against ``repro.data``.

``make_batch`` draws with numpy as the JAX package does, so one seed gives
bit-equal tokens, labels, patches (vlm) and frames (audio): held exactly
for gpt-paper (dense), internvl2-1b (vlm) and hubert-xlarge (audio) at two
seeds each, at reduced and at full width, and for the first two items of
``synthetic_stream``.  ``batch_specs`` gives ``meta`` tensors of the JAX
specs' shapes and dtypes.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import batch_specs as jbatch_specs
from repro.data import make_batch as jmake_batch
from repro.data import synthetic_stream as jstream
from repro_torch.configs import get_config
from repro_torch.data import batch_specs, make_batch, synthetic_stream

torch.set_num_threads(2)

ARCHS = ["gpt-paper", "internvl2-1b", "hubert-xlarge"]


def _cfgs(arch, reduced):
    cfg, jcfg = get_config(arch), jax_config(arch)
    return (cfg.reduced(), jcfg.reduced()) if reduced else (cfg, jcfg)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_bit_equal(arch, reduced, seed):
    cfg, jcfg = _cfgs(arch, reduced)
    S = 48 if reduced else 16
    _same(make_batch(cfg, 3, S, seed=seed, device="cpu"), jmake_batch(jcfg, 3, S, seed=seed))
    # without labels, and a length below the copied window's minimum
    _same(make_batch(cfg, 2, 5, seed=seed, with_labels=False, device="cpu"),
          jmake_batch(jcfg, 2, 5, seed=seed, with_labels=False))


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_stream_items_bit_equal(arch):
    cfg, jcfg = _cfgs(arch, True)
    ours = synthetic_stream(cfg, 2, 32, seed=3, device="cpu")
    theirs = jstream(jcfg, 2, 32, seed=3)
    for _ in range(2):
        _same(next(ours), next(theirs))


def test_batch_shape_structure():
    cfg = get_config("gpt-paper").reduced()
    b = make_batch(cfg, 2, 32, seed=1, device="cpu")
    t = b["tokens"].numpy()
    # labels are the tokens shifted left by one, wrapping; the copied window
    np.testing.assert_array_equal(b["labels"].numpy(), np.roll(t, -1, axis=1))
    np.testing.assert_array_equal(t[:, 16:24], t[:, :8])
    assert t.min() >= 0 and t.max() < cfg.vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_jax(arch):
    cfg, jcfg = _cfgs(arch, False)
    for with_labels in (True, False):
        got = batch_specs(cfg, 4, 128, with_labels=with_labels)
        want = jbatch_specs(jcfg, 4, 128, with_labels=with_labels)
        assert sorted(got) == sorted(want)
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(spec.shape), k
            assert np.dtype(str(got[k].dtype).replace("torch.", "")) == np.dtype(spec.dtype)
        real = make_batch(cfg.reduced(), 1, 8, device="cpu", with_labels=with_labels)
        assert sorted(real) == sorted(got)
        assert all(real[k].dtype == got[k].dtype for k in got)


def test_make_batch_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch(get_config("gpt-paper").reduced(), 1, 8)
