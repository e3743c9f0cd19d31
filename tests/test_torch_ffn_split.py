"""A model of the bf16 ``chunked_ffn`` kernel's split and sum, on the CPU.

The CUDA kernel (``csrc/chunked_ffn.cu``, ``ffn_wgmma_kernel``) splits the
work into units of (pair of 128-row tiles, f chunk of 256 columns); a
cluster of two blocks, one per row tile of the pair, takes every
n_clusters-th unit, units ordered by groups of 4 pairs, then chunk, then
pair.  Per unit it keeps h = silu(g) * u in f32 as bf16 hi + lo in shared
memory (gate and up 128 columns at a time), multiplies both parts by the
chunk's rows of w_down 192 output columns at a time, and adds each partial
into an f32 (rows, d) workspace that is zeroed first and cast to bf16 last.
This file models that walk in float32 on bf16 inputs and holds it against
the plain version and the Pallas kernel in interpret mode: bf16 2e-3 +
2^-7 |want| (each rounds an f32 sum to 8 mantissa bits once and may land
one unit apart); against the unsplit f32 sum of the same products, 1e-5
(only the order of the f32 adds differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunked_ffn import chunked_ffn as jchunked_ffn
from repro_torch.kernels import chunked_ffn as CF

torch.set_num_threads(2)
BM, FT, FC, DN = 128, 128, 256, 192     # the kernel's tiles
GROUP_PAIRS = 4                         # pairs of row tiles a group of units spans
N_SM = 132                              # an H100 SXM's multiprocessors
TOL_BF16 = (2e-3, 2.0 ** -7)


def _pairs(rows):
    """Pairs of 128-row tiles (a cluster's two blocks) that cover ``rows``."""
    return -(-(-(-rows // BM)) // 2)


def unit_plan(rows, f, n_sm=N_SM):
    """Per cluster, its units [(pair, chunk)] in order, as the launcher and
    the kernel's ``Walk`` compute them."""
    n_pairs, n_ch = _pairs(rows), -(-f // FC)
    n_units = n_pairs * n_ch
    n_clusters = max(1, min(n_sm // 2, n_units))

    def unit(u):
        g, r = divmod(u, GROUP_PAIRS * n_ch)
        pairs = min(GROUP_PAIRS, n_pairs - g * GROUP_PAIRS)
        return g * GROUP_PAIRS + r % pairs, r // pairs

    return [[unit(u) for u in range(k, n_units, n_clusters)] for k in range(n_clusters)]


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def split_model(x, wg, wu, wd, *, n_sm=N_SM, order=None):
    """The kernel's arithmetic on float32 copies of bf16 inputs: per
    cluster, per unit, for each block of the pair, h in f32 split into bf16
    hi + lo, partials of 192 output columns added into a zeroed f32
    workspace (clusters in ``order``)."""
    rows, d = x.shape
    f = wg.shape[1]
    ws = np.zeros((rows, d), np.float32)
    clusters = unit_plan(rows, f, n_sm)
    for k in (order if order is not None else range(len(clusters))):
        for (pair, ch), rank in ((pc, rank) for pc in clusters[k] for rank in (0, 1)):
            r = slice((2 * pair + rank) * BM, min((2 * pair + rank + 1) * BM, rows))
            if r.start >= rows:
                continue
            cols = slice(ch * FC, min((ch + 1) * FC, f))
            g = x[r] @ wg[:, cols]
            u = x[r] @ wu[:, cols]
            h = (g / (1 + np.exp(-g)) * u).astype(np.float32)
            hi = _bf16(h)
            lo = _bf16(h - hi)
            for n0 in range(0, d, DN):
                n = slice(n0, min(n0 + DN, d))
                ws[r, n] += hi @ wd[cols, n] + lo @ wd[cols, n]
    return ws


def _inputs(S, d, f, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((S, d), dtype=np.float32) * 0.3)
    w_in = _bf16(rng.standard_normal((d, 2 * f), dtype=np.float32) * 0.05)
    wd = _bf16(rng.standard_normal((f, d), dtype=np.float32) * 0.05)
    return x, w_in[:, f:], w_in[:, :f], wd


@pytest.mark.parametrize("rows,f,n_sm", [(4096, 9216, 132), (2048, 9216, 132), (17, 9216, 132),
                                         (300, 384, 132), (1000, 1280, 6)])
def test_units_cover_every_chunk_once(rows, f, n_sm):
    """Each (pair, chunk) is summed by exactly one cluster; at minitron's
    chunk 66 clusters (one block an SM) take 8 or 9 of its 576 units, and
    the units in flight at once span at most two groups of 4 pairs."""
    clusters = unit_plan(rows, f, n_sm)
    n_pairs, n_ch = _pairs(rows), -(-f // FC)
    seen = sorted(pc for units in clusters for pc in units)
    assert seen == [(p, c) for p in range(n_pairs) for c in range(n_ch)]
    if (rows, f) == (4096, 9216):
        assert len(clusters) == 66 and {len(u) for u in clusters} == {8, 9}
        for step in range(9):
            pairs = {units[step][0] for units in clusters if step < len(units)}
            assert len({p // GROUP_PAIRS for p in pairs}) <= 2


@pytest.mark.parametrize("S,d,f", [(300, 128, 384), (17, 64, 256), (130, 320, 128)],
                         ids=["f-chunk-of-one-tile", "ragged-s17", "d-off-the-192-tile"])
def test_split_model_matches_plain_and_pallas(S, d, f):
    x, wg, wu, wd = _inputs(S, d, f, seed=S + d)
    got = split_model(x, wg, wu, wd)
    got16 = torch.from_numpy(got).bfloat16().float().numpy()
    tx, twg, twu, twd = (torch.from_numpy(a).bfloat16() for a in (x, wg, wu, wd))
    plain = CF.chunked_ffn_plain(tx, twg, twu, twd).float().numpy()
    atol, rtol = TOL_BF16
    np.testing.assert_allclose(got16, plain, atol=atol, rtol=rtol)
    pallas = np.asarray(jchunked_ffn(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, wg, wu, wd)),
                                     block_s=64, block_f=128, interpret=True), np.float32)
    np.testing.assert_allclose(got16, pallas, atol=atol, rtol=rtol)
    # hi + lo carries h to about 2^-17: the f32 result is the unsplit one's
    h = x @ wg
    h = h / (1 + np.exp(-h)) * (x @ wu)
    np.testing.assert_allclose(got, h.astype(np.float32) @ wd, atol=1e-5)


def test_block_order_only_reorders_f32_adds():
    """The atomics land in any order: the workspace differs by f32 rounding
    only, far inside one bf16 unit."""
    x, wg, wu, wd = _inputs(260, 128, 768, seed=9)
    n = len(unit_plan(260, 768, n_sm=6))
    a = split_model(x, wg, wu, wd, n_sm=6)
    b = split_model(x, wg, wu, wd, n_sm=6, order=list(reversed(range(n))))
    np.testing.assert_allclose(a, b, atol=1e-6)
