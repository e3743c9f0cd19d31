"""A model of the bf16 ``masked_attention`` kernel's tile skip, on the CPU.

The CUDA kernel first classifies the bool mask by 64 x 64 tiles (dead: no
live entry; full: every in-range entry live; partial), then each block of
64 query rows walks only the kv tiles it must: every non-dead tile, or
every tile at all when one of its rows has no live key anywhere (that row
gets the mean of all V, as the reference gives).  This file models that
walk in numpy -- the classes, the visit lists, an online softmax in f32
over the visited tiles with masked logits at -1e30 -- and holds it against
the plain version and the Pallas kernel in interpret mode.  Cases: a
causal mask with dead tiles, a fully masked row, per-head masks, GQA,
ragged Sq and Skv.  Tolerance: 1e-5 in float32 (another summation order).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import chunked_attention as CA

JCA = importlib.import_module("repro.kernels.chunked_attention")
torch.set_num_threads(2)
DEAD, FULL, PARTIAL = 0, 1, 2
B = 64      # the kernel's query and kv tile


def tile_classes(mask):
    """(classes (Nm, n_qt, n_kt), row_live (Nm, Sq)) of a bool mask, over
    in-range entries only, as ``mask_classify_kernel`` computes them."""
    nm, sq, skv = mask.shape
    n_qt, n_kt = -(-sq // B), -(-skv // B)
    cls = np.empty((nm, n_qt, n_kt), np.int64)
    for h in range(nm):
        for qt in range(n_qt):
            for t in range(n_kt):
                tile = mask[h, qt * B:(qt + 1) * B, t * B:(t + 1) * B]
                cls[h, qt, t] = FULL if tile.all() else PARTIAL if tile.any() else DEAD
    return cls, mask.any(axis=2)


def visit_lists(cls, row_live):
    """Per (mask head, query tile): [(kv tile, class)] in order, as
    ``mask_list_kernel`` writes them."""
    nm, n_qt, n_kt = cls.shape
    out = {}
    for h in range(nm):
        for qt in range(n_qt):
            keep_all = not row_live[h, qt * B:(qt + 1) * B].all()
            out[h, qt] = [(t, int(cls[h, qt, t])) for t in range(n_kt)
                          if keep_all or cls[h, qt, t] != DEAD]
    return out


def skip_model(q, k, v, mask, scale, group):
    """The kernel's walk: per query head and query tile, an online softmax
    over the listed kv tiles only; returns (out, tiles visited, tiles)."""
    nq, sq, hd = q.shape
    skv = k.shape[1]
    cls, row_live = tile_classes(mask)
    lists = visit_lists(cls, row_live)
    out = np.zeros((nq, sq, hd), np.float32)
    visited = 0
    for n in range(nq):
        h = 0 if mask.shape[0] == 1 else n
        kn, vn = k[n // group], v[n // group]
        for qt in range(-(-sq // B)):
            rows = slice(qt * B, min((qt + 1) * B, sq))
            qs = q[n, rows]
            m = np.full(qs.shape[0], -1e30, np.float32)
            l = np.zeros(qs.shape[0], np.float32)
            acc = np.zeros((qs.shape[0], hd), np.float32)
            for t, c in lists[h, qt]:
                keys = slice(t * B, min((t + 1) * B, skv))
                s = (qs @ kn[keys].T) * np.float32(scale)
                if c != FULL:          # a dead tile's entries all take -1e30
                    s = np.where(mask[h, rows, keys], s, np.float32(-1e30))
                m_new = np.maximum(m, s.max(axis=1))
                alpha = np.exp(m - m_new)
                p = np.exp(s - m_new[:, None])
                l = alpha * l + p.sum(axis=1)
                acc = alpha[:, None] * acc + p @ vn[keys]
                m = m_new
            out[n, rows] = acc / np.maximum(l, 1e-30)[:, None]
            visited += len(lists[h, qt])
    return out, visited, nq * cls.shape[1] * cls.shape[2]


def _inputs(N, group, Sq, Skv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N * group, Sq, hd), dtype=np.float32),
            rng.standard_normal((N, Skv, hd), dtype=np.float32),
            rng.standard_normal((N, Skv, hd), dtype=np.float32))


def _causal(Sq, Skv, heads=1, window=None):
    qpos = Skv - Sq + np.arange(Sq)[:, None]
    kpos = np.arange(Skv)[None, :]
    band = (kpos <= qpos) & (qpos - kpos < (window or Skv + 1))
    return np.broadcast_to(band, (heads, Sq, Skv)).copy()


# (N, group, Sq, Skv, the function that makes the mask)
CASES = {
    "causal-dead-tiles": (2, 1, 128, 256, lambda rng, nm, sq, skv: _causal(sq, skv)),
    "empty-row": (2, 2, 96, 200,
                  lambda rng, nm, sq, skv: _with_empty_row(_causal(sq, skv, window=64))),
    "per-head-gqa": (2, 2, 70, 130, lambda rng, nm, sq, skv: _per_head(rng, 4, sq, skv)),
    "ragged-random": (1, 3, 17, 150, lambda rng, nm, sq, skv: rng.random((1, sq, skv)) < 0.3),
}


def _with_empty_row(m):
    m[:, 70] = False                      # query tile 1 must visit every kv tile
    return m


def _per_head(rng, heads, sq, skv):
    m = np.zeros((heads, sq, skv), bool)
    m[0] = _causal(sq, skv)[0]
    m[1, :, :64] = True                   # one full kv tile, the rest dead
    m[2] = rng.random((sq, skv)) < 0.5
    m[3, :, 100:] = rng.random((sq, skv - 100)) < 0.2     # dead first tile
    return m


@pytest.mark.parametrize("case", sorted(CASES))
def test_skip_model_matches_plain_and_pallas(case):
    N, group, Sq, Skv, build = CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = _inputs(N, group, Sq, Skv, 32, seed=Sq)
    mask = build(rng, N * group, Sq, Skv)
    scale = 32 ** -0.5
    got, visited, tiles = skip_model(q, k, v, mask, scale, group)
    want = CA.masked_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                     torch.from_numpy(mask), scale=scale, group=group).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    pallas = JCA.masked_attention(jnp.asarray(q), jnp.repeat(jnp.asarray(k), group, axis=0),
                                  jnp.repeat(jnp.asarray(v), group, axis=0),
                                  jnp.asarray(mask), scale=scale, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5)
    cls, row_live = tile_classes(mask)
    if (cls == DEAD).any() and row_live.all():
        assert visited < tiles                # dead tiles were skipped
    assert visited <= tiles


def test_a_query_tile_with_an_empty_row_visits_every_tile():
    mask = _with_empty_row(_causal(96, 200, window=64))
    cls, row_live = tile_classes(mask)
    lists = visit_lists(cls, row_live)
    assert [t for t, _ in lists[0, 1]] == [0, 1, 2, 3]          # every kv tile
    assert (cls[0, 0] == DEAD).any() and len(lists[0, 0]) < 4    # tile 0 skips
    assert lists[0, 1][0] == (0, DEAD)          # walked, masked whole


def test_classes_count_in_range_entries_only():
    """A ragged edge tile whose real entries are all live is full: the
    kernel gives keys past Skv weight 0 on its own."""
    mask = np.ones((1, 17, 100), bool)
    cls, _ = tile_classes(mask)
    assert cls.tolist() == [[[FULL, FULL]]]
    mask[0, :, 64:] = False
    assert tile_classes(mask)[0].tolist() == [[[FULL, DEAD]]]


def test_workspace_bytes_cover_the_tiles():
    """bf16 calls allocate the bit tiles (512 B each), the visit lists and
    counts, the classes and one byte a row; f32 calls allocate nothing."""
    n_qt, n_kt = 64, 128
    want = n_qt * n_kt * (512 + 4 + 1) + n_qt * 4 + 4096
    assert CA.masked_workspace_bytes(1, 4096, 8192, torch.bfloat16) == want
    assert CA.masked_workspace_bytes(12, 4096, 8192, torch.bfloat16) == 12 * want
    assert CA.masked_workspace_bytes(1, 4096, 8192, torch.float32) == 0
    assert CA.masked_workspace_bytes(1, 17, 100, torch.bfloat16) == 2 * 517 + 4 + 17
