"""Port attention kernels (plain versions, CPU) against the JAX Pallas kernels.

The same numpy inputs go through ``repro.kernels.chunked_attention``'s
``computed_attention`` / ``masked_attention`` in interpret mode (K and V
repeated per query head, as ``ops._expand_gqa`` does) and through the port's
wrappers on CPU tensors, which run the plain PyTorch versions with native
GQA, at hd 32 and at the head dims 80 (hubert-xlarge), 96 (phi3-mini) and
256 (recurrentgemma's local attention).  Tolerances: float32 1e-5 (the two sum in another order); bfloat16
2e-3 + 2^-7 |want| (both round an f32 result to 8 mantissa bits and may land
one unit apart).
"""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.tiling import legal_block
from repro_torch.kernels import chunked_attention as CA

# the package re-exports a function of the same name; take the module
JCA = importlib.import_module("repro.kernels.chunked_attention")
torch.set_num_threads(2)

TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-3, 2.0 ** -7)}


def _inputs(N, group, Sq, Skv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((N * group, Sq, hd), dtype=np.float32)
    k = rng.standard_normal((N, Skv, hd), dtype=np.float32)
    v = rng.standard_normal((N, Skv, hd), dtype=np.float32)
    tq = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    # the JAX side gets the same (already rounded) values
    jq = [jnp.asarray(t.float().numpy()).astype(dtype) for t in tq]
    return tq, jq


def _jax_repeat(k, group):
    return jnp.repeat(k, group, axis=0)


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


# (hd, N, Sq, Skv, group, causal, window, q_offset)
COMPUTED = [
    pytest.param(32, 2, 17, 60, 1, True, None, 43, id="sq17-causal-last-chunk"),
    pytest.param(32, 2, 60, 128, 2, True, None, 0, id="sq60-causal-first-gqa2"),
    pytest.param(32, 2, 128, 256, 4, True, None, 64, id="sq128-causal-mid-gqa4"),
    pytest.param(32, 2, 60, 128, 1, False, None, 0, id="sq60-full"),
    pytest.param(32, 2, 17, 60, 2, True, 16, 43, id="sq17-window-gqa2"),
    pytest.param(32, 2, 128, 256, 1, True, 32, 128, id="sq128-window-last-chunk"),
] + [
    # the head dims of hubert-xlarge (80), phi3-mini (96) and recurrentgemma's
    # local attention (256): causal with ragged Sq and Skv; and
    # recurrentgemma's MQA, 16 query heads over 1, in a window whose first 5
    # rows see no key (Skv 64: the Pallas kernel's kv block and the CUDA
    # kernel's tile are the same, so both average V over the same keys)
    pytest.param(hd, N, Sq, Skv, group, True, window, off, id=f"hd{hd}-{name}")
    for hd in (80, 96, 256)
    for name, N, group, Sq, Skv, off, window in (
        ("ragged", 2, 2, 37, 100, 50, None),
        ("mqa-window-dead-rows", 1, 16, 40, 64, -5, 16))
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,N,Sq,Skv,group,causal,window,q_offset", COMPUTED)
def test_computed_matches_pallas_interpret(hd, N, Sq, Skv, group, causal, window, q_offset,
                                           dtype):
    (q, k, v), (jq, jk, jv) = _inputs(N, group, Sq, Skv, hd, dtype,
                                      seed=Sq + group + hd - 32)
    scale = hd ** -0.5
    want = JCA.computed_attention(jq, _jax_repeat(jk, group), _jax_repeat(jv, group),
                                  scale=scale, causal=causal, window=window,
                                  q_offset=q_offset, interpret=True)
    got = CA.computed_attention(q, k, v, q_offset, scale=scale, causal=causal,
                                window=window, group=group)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_computed_default_offset_matches_attention_ref(dtype):
    """q_offset=None right-aligns the queries, as ``ref.attention_ref`` does."""
    (q, k, v), (jq, jk, jv) = _inputs(4, 1, 17, 60, 16, dtype, seed=3)
    got = CA.computed_attention(q, k, v, scale=16 ** -0.5)
    # attention_ref takes (B, S, H, hd)
    want = jref.attention_ref(jnp.moveaxis(jq, 0, 1)[None], jnp.moveaxis(jk, 0, 1)[None],
                              jnp.moveaxis(jv, 0, 1)[None], causal=True)
    _close(got, np.moveaxis(np.asarray(want[0], np.float32), 1, 0), dtype)


def test_computed_rows_with_no_live_key_follow_the_tile_skip():
    """Rows before key 0 see no live key: they get the mean of V over the
    keys of the kv tiles the band visits, as the Pallas kernel's skip does
    at its own tile sizes."""
    (q, k, v), (jq, jk, jv) = _inputs(2, 1, 40, 96, 16, "float32", seed=5)
    scale = 0.25
    want = np.asarray(JCA.computed_attention(jq, jk, jv, scale=scale, causal=True,
                                             q_offset=-5, interpret=True))
    bq, bkv = legal_block(40, 128), legal_block(96, 128)
    got = CA.computed_attention_plain(q, k, v, -5, scale=scale, causal=True,
                                      block_q=bq, block_kv=bkv)
    _close(got, want, "float32")
    # at the CUDA kernel's 64 x 64 tiles the first query tile reaches only
    # the first kv tile: the dead rows average V over keys 0..63
    got = CA.computed_attention(q, k, v, -5, scale=scale, causal=True)
    np.testing.assert_allclose(got[:, :5].numpy(),
                               v[:, None, :64].mean(dim=2).expand(2, 5, 16).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got[:, 5:].numpy(), want[:, 5:], atol=1e-5)


# (hd, N, Sq, Skv, group, per_head)
MASKED = [
    pytest.param(32, 2, 17, 60, 1, False, id="sq17-shared-mask"),
    pytest.param(32, 2, 60, 128, 2, True, id="sq60-per-head-gqa2"),
    pytest.param(32, 2, 128, 128, 4, False, id="sq128-shared-gqa4"),
] + [
    # hd 80, 96 and 256: recurrentgemma's MQA (16 query heads over 1), ragged
    # Sq and Skv, a mask per query head
    pytest.param(hd, 1, 24, 90, 16, True, id=f"hd{hd}-mqa-per-head") for hd in (80, 96, 256)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,N,Sq,Skv,group,per_head", MASKED)
def test_masked_matches_pallas_interpret(hd, N, Sq, Skv, group, per_head, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(N, group, Sq, Skv, hd, dtype,
                                      seed=Skv + group + hd - 32)
    rng = np.random.default_rng(Sq)
    mask = rng.random((N * group if per_head else 1, Sq, Skv)) < 0.6
    mask[:, 3, :] = False                  # a row with no live key
    scale = hd ** -0.5
    want = JCA.masked_attention(jq, _jax_repeat(jk, group), _jax_repeat(jv, group),
                                jnp.asarray(mask), scale=scale, interpret=True)
    got = CA.masked_attention(q, k, v, torch.from_numpy(mask), scale=scale, group=group)
    _close(got, want, dtype)
    # the dead row is the mean of V, as in the Pallas kernel
    mean_v = v.float().repeat_interleave(group, dim=0).mean(dim=1)
    _close(got[:, 3], mean_v.numpy(), dtype)


def test_wrappers_check_shapes_and_devices():
    q = torch.zeros((4, 8, 32))
    k = torch.zeros((2, 8, 32))
    with pytest.raises(ValueError):
        CA.computed_attention(q, k, k, scale=1.0)            # 4 q heads, 2 kv, group 1
    with pytest.raises(ValueError):
        CA.masked_attention(q, k, k, torch.ones((3, 8, 8), dtype=torch.bool),
                            scale=1.0, group=2)              # mask heads not in {1, 4}
    with pytest.raises(TypeError):
        CA.computed_attention(q, k.half(), k.half(), scale=1.0, group=2)
    before = (CA.computed_attention.launches, CA.masked_attention.launches)
    CA.computed_attention(q, k, k, scale=1.0, group=2)      # CPU: the plain version
    assert (CA.computed_attention.launches, CA.masked_attention.launches) == before


def test_kernel_tiles_are_the_plain_versions_tiles():
    """Both CUDA kernels walk kBQ x kBKV tiles, and the plain version's band
    (which decides what a row with no live key averages over) assumes
    BLOCK_Q x BLOCK_KV: the two must be the same numbers."""
    src = (Path(CA.__file__).parent / "csrc" / "chunked_attention.cu").read_text()
    tiles = {name: int(val) for name, val in
             re.findall(r"constexpr int (kBQ|kBKV) = (\d+);", src)}
    assert tiles == {"kBQ": CA.BLOCK_Q, "kBKV": CA.BLOCK_KV}
    # the tensor-core kernel is built around the same constants
    assert "static_assert(kBQ == 64 && kBKV == 64" in src
    assert (CA.BLOCK_Q, CA.BLOCK_KV) == (64, 64)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# inputs that pass the shape checks but that no CUDA kernel takes; on a
# non-CPU tensor the wrapper raises before reaching any device
NO_KERNEL = {
    "hd16": (dict(q=_meta((4, 8, 16)), k=_meta((2, 8, 16))), "hd in"),
    "hd48": (dict(q=_meta((4, 8, 48)), k=_meta((2, 8, 48))), "hd in"),
    # hd 256 has an instance: it passes the head-dim gate and is refused
    # only for the device
    "hd256": (dict(q=_meta((4, 8, 256)), k=_meta((2, 8, 256))), "no kernel for device"),
    "non_contiguous_q": (dict(q=_meta((4, 64, 8)).transpose(1, 2), k=_meta((2, 8, 64))),
                         "contiguous"),
    "meta_device": (dict(q=_meta((4, 8, 64)), k=_meta((2, 8, 64))), "no kernel for device"),
}


@pytest.mark.parametrize("kernel", ["computed", "masked"])
@pytest.mark.parametrize("what", sorted(NO_KERNEL))
def test_wrappers_reject_what_no_kernel_takes(what, kernel):
    args, message = NO_KERNEL[what]
    q, k = args["q"], args["k"]
    before = (CA.computed_attention.launches, CA.masked_attention.launches)
    with pytest.raises(ValueError, match=message):
        if kernel == "computed":
            CA.computed_attention(q, k, k, scale=1.0, group=2)
        else:
            mask = torch.empty((1, q.shape[1], k.shape[1]), dtype=torch.bool, device="meta")
            CA.masked_attention(q, k, k, mask, scale=1.0, group=2)
    assert (CA.computed_attention.launches, CA.masked_attention.launches) == before


def test_band_tiles_bound_the_walk():
    # causal, queries right-aligned at 1000..1099 against 1100 keys: the
    # first query tile ends at position 1063, in kv tile 16
    los, his = CA.band_tiles(100, 1100, 1000, causal=True, window=None)
    assert los == [0, 0] and his == [17, 18]
    # a window of 64 starts the walk at the tile holding key qpos - 63
    los, _ = CA.band_tiles(100, 1100, 1000, causal=True, window=64)
    assert los == [(1000 - 63) // 64, (1064 - 63) // 64]
