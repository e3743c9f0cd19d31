"""Port paged attention against the JAX Pallas kernel and its oracle.

The same numpy inputs go to ``repro.kernels.paged_attention_blocked`` (run
in interpret mode, as the JAX package's own tests run it on the CPU) and to
the port's ``paged_attention_blocked`` on CPU tensors, which takes the plain
PyTorch version.  Outputs agree on real query rows to atol 1e-5 (float32;
the two frameworks sum in different orders).  The JAX kernel leaves padding
rows as garbage; the port writes zeros there.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_blocked as jax_paged
from repro.kernels.ref import paged_attention_ref as jax_ref
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels.ref import paged_attention_ref

torch.set_num_threads(2)
ATOL = 1e-5


def _case(q_lens, kv_lens, *, H, Kv, hd, ps, seed=0, spare_pages=2):
    """A ragged batch in the paged layout.

    Pages are handed out in shuffled order, ``spare_pages`` pages belong to
    no sequence and hold large values, and page-table entries past a row's
    page count hold out-of-range ids (both sides clamp and never use them).
    """
    rng = np.random.default_rng(seed)
    S = len(q_lens)
    q_max = max(max(q_lens), 1)
    n_used = [-(-kl // ps) for kl in kv_lens]
    P = sum(n_used) + spare_pages
    max_pages = max(max(n_used), 1) + 1
    pages = np.full((P, ps, 2 * Kv, hd), 1e4, np.float32)
    table = rng.integers(P, 4 * P, (S, max_pages)).astype(np.int32)
    order = rng.permutation(P).tolist()
    for s, n in enumerate(n_used):
        for j in range(n):
            pid = order.pop()
            table[s, j] = pid
            pages[pid] = rng.standard_normal((ps, 2 * Kv, hd))
    q = rng.standard_normal((S, q_max, H, hd)).astype(np.float32)
    return (q, pages, table, np.asarray(q_lens, np.int32),
            np.asarray(kv_lens, np.int32))


CASES = {
    # name: (q_lens, kv_lens, H, Kv, hd, page_size)
    "decode_rows": ([1, 1, 1], [9, 17, 4], 4, 4, 32, 8),
    "prefill_rows": ([8, 16], [8, 16], 4, 4, 64, 8),
    "kv_len_off_page": ([5, 11, 3], [13, 11, 30], 4, 4, 32, 8),
    "mixed_with_padding_rows": ([8, 1, 0, 5, 1], [24, 13, 0, 5, 1], 4, 4, 64, 4),
    "gqa_mixed": ([6, 1, 3, 0], [20, 7, 3, 0], 4, 2, 32, 8),
    "gqa_hd64_page16": ([1, 12, 1], [40, 12, 33], 4, 2, 64, 16),
    # head dims the CUDA kernel has no instance for (cuda_refusal): the
    # function takes them, as the JAX kernel does (phi3-mini's hd 96)
    "gqa_hd96_mixed": ([5, 1, 1], [21, 9, 30], 4, 2, 96, 8),
    "hd16_mixed": ([4, 1, 0], [11, 6, 0], 2, 2, 16, 4),
}


def _real_rows(out, q_lens):
    return np.concatenate([np.asarray(out[s, :ql]) for s, ql in enumerate(q_lens)], 0)


def _port(q, pages, table, q_lens, kv_lens):
    return PA.paged_attention_blocked(
        torch.tensor(q), torch.tensor(pages), torch.tensor(table),
        torch.tensor(q_lens), torch.tensor(kv_lens))


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_kernel(name):
    q_lens, kv_lens, H, Kv, hd, ps = CASES[name]
    q, pages, table, ql, kl = _case(q_lens, kv_lens, H=H, Kv=Kv, hd=hd, ps=ps)
    before = PA.paged_attention_blocked.launches
    ours = _port(q, pages, table, ql, kl).numpy()
    assert PA.paged_attention_blocked.launches == before  # CPU: plain version
    theirs = jax_paged(jnp.asarray(q), jnp.asarray(pages), jnp.asarray(table),
                       jnp.asarray(ql), jnp.asarray(kl), interpret=True)
    assert ours.shape == q.shape and ours.dtype == np.float32
    np.testing.assert_allclose(_real_rows(ours, q_lens), _real_rows(theirs, q_lens),
                               atol=ATOL, rtol=0)
    # padding rows (i >= q_len) are zeros, not garbage
    pad = np.arange(q.shape[1])[None, :] >= ql[:, None]
    assert (ours[pad] == 0).all()


def _flat_case(name, seed=1):
    q_lens, kv_lens, H, Kv, hd, ps = CASES[name]
    q, pages, table, ql, kl = _case(q_lens, kv_lens, H=H, Kv=Kv, hd=hd, ps=ps, seed=seed)
    table = np.clip(table, 0, pages.shape[0] - 1)
    cu_q = np.cumsum([0] + list(q_lens)).astype(np.int32)
    cu_kv = np.cumsum([0] + list(kv_lens)).astype(np.int32)
    # the oracles' flat ragged layout; rows with q_len 0 carry nothing
    flat = _real_rows(q, q_lens)
    return (q, pages, table, ql, kl), (flat, pages, table, cu_q, cu_kv)


def test_oracle_matches_jax_oracle():
    # The JAX oracle compiles every op anew for each shape (seconds per
    # case), so it is held against the port on the one case that has every
    # row kind: decode, prefill, q_len 0, kv_len off the page edge, GQA.
    _, flat_args = _flat_case("gqa_mixed")
    ours = paged_attention_ref(*[torch.tensor(a) for a in flat_args]).numpy()
    theirs = jax_ref(*[jnp.asarray(a) for a in flat_args])
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_oracle_matches_blocked(name):
    blocked_args, flat_args = _flat_case(name)
    ours = paged_attention_ref(*[torch.tensor(a) for a in flat_args]).numpy()
    blocked = _real_rows(_port(*blocked_args).numpy(), CASES[name][0])
    np.testing.assert_allclose(blocked, ours, atol=ATOL, rtol=0)


def test_bfloat16_plain_version_rounds_like_its_inputs():
    q_lens, kv_lens, H, Kv, hd, ps = CASES["gqa_mixed"]
    q, pages, table, ql, kl = _case(q_lens, kv_lens, H=H, Kv=Kv, hd=hd, ps=ps, seed=2)
    qb, pb = torch.tensor(q).bfloat16(), torch.tensor(pages).bfloat16()
    out = PA.paged_attention_blocked(qb, pb, torch.tensor(table), torch.tensor(ql),
                                     torch.tensor(kl))
    assert out.dtype == torch.bfloat16
    ref = _port(qb.float().numpy(), pb.float().numpy(), table, ql, kl)
    # one rounding of the f32 result to 8 mantissa bits: half a unit in the
    # last place, at most 2^-8 |out|
    torch.testing.assert_close(out.float(), ref, atol=1e-6, rtol=2.0 ** -8)


# decode batches that the kernel splits: a kv_len no multiple of the split,
# splits wholly past kv_len (the table is wider than every row), a row with
# q_len 0; GQA
SPLIT_CASES = {
    # name: (q_lens, kv_lens, H, Kv, hd, page_size)
    "decode_splits_past_kv_len": ([1, 1, 0, 1], [300, 1, 0, 520], 4, 2, 32, 16),
    "decode_one_long_row": ([1, 1], [700, 17], 2, 1, 64, 8),
}
ALL_CASES = {**CASES, **SPLIT_CASES}


def split_merge_model(q, pages, table, q_lens, kv_lens, split_keys):
    """Plain model of the CUDA kernel's split-and-merge: each row's keys
    below min(kv_len, table width) cut into ranges of ``split_keys``; per
    range the partial (m, l, acc) of every query vector, (-inf, 0, 0) where
    the range is empty; then the log-sum-exp merge of the partials,
    acc / max(l, 1e-30).  Masked keys score -1e30; padding rows are zeros."""
    S, q_max, H, hd = q.shape
    P, ps, two_kv, _ = pages.shape
    G = H // (two_kv // 2)
    width = table.shape[1] * ps
    k, v = PA.split_kv(pages[table.long().clamp(0, P - 1)].reshape(S, width, two_kv, hd))
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)   # (S, width, H, hd)
    out = torch.zeros_like(q)
    for s in range(S):
        ql, kl = int(q_lens[s]), int(kv_lens[s])
        limit = min(kl, width)
        for i in range(ql):
            qpos = kl - ql + i
            parts = []
            for k0 in range(0, width, split_keys):
                keys = torch.arange(k0, max(k0, min(k0 + split_keys, limit)))
                if len(keys) == 0:
                    parts.append((torch.full((H,), float("-inf")), torch.zeros(H),
                                  torch.zeros(H, hd)))
                    continue
                x = torch.einsum("nhd,hd->hn", k[s, keys], q[s, i]) * hd ** -0.5
                x = torch.where(keys[None, :] <= qpos, x, PA.NEG_INF)
                m = x.amax(dim=1)
                p = torch.exp(x - m[:, None])
                parts.append((m, p.sum(dim=1), torch.einsum("hn,nhd->hd", p, v[s, keys])))
            ms = torch.stack([m for m, _, _ in parts])                      # (n_split, H)
            mm = ms.amax(dim=0)
            w = torch.where(ms == float("-inf"), 0.0, torch.exp(ms - mm))
            sum_l = (w * torch.stack([l for _, l, _ in parts])).sum(dim=0)
            acc = (w[..., None] * torch.stack([a for _, _, a in parts])).sum(dim=0)
            out[s, i] = acc / sum_l.clamp_min(1e-30)[:, None]
    return out


@functools.lru_cache(maxsize=None)
def _jax_out(name):
    q_lens, kv_lens, H, Kv, hd, ps = ALL_CASES[name]
    q, pages, table, ql, kl = _case(q_lens, kv_lens, H=H, Kv=Kv, hd=hd, ps=ps)
    return np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(pages), jnp.asarray(table),
                                jnp.asarray(ql), jnp.asarray(kl), interpret=True))


@pytest.mark.parametrize("split", ["kernel", "page"])
@pytest.mark.parametrize("name", sorted(ALL_CASES))
def test_split_merge_model_matches_plain_and_jax(name, split):
    """The kernel's split-and-merge, modelled in plain PyTorch at the
    kernel's own split size (``split_plan``'s) and at one page a split (many
    partials, most past kv_len on the short rows), against the plain version
    and the Pallas kernel."""
    q_lens, kv_lens, H, Kv, hd, ps = ALL_CASES[name]
    q, pages, table, ql, kl = _case(q_lens, kv_lens, H=H, Kv=Kv, hd=hd, ps=ps)
    split_keys = PA.split_plan(ps, table.shape[1])[1] if split == "kernel" else ps
    args = [torch.tensor(a) for a in (q, pages, table, ql, kl)]
    got = split_merge_model(*args, split_keys).numpy()
    np.testing.assert_allclose(got, PA.paged_attention_blocked_plain(*args).numpy(),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(_real_rows(got, q_lens), _real_rows(_jax_out(name), q_lens),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("page_size,max_pages,want", [
    pytest.param(16, 128, (8, 256), id="serving"),
    pytest.param(16, 16, (1, 256), id="one-split"),
    pytest.param(48, 20, (4, 288), id="split-rounded-to-pages"),
    pytest.param(1, 600, (3, 256), id="page-size-1"),
])
def test_split_plan_from_the_table_shape(page_size, max_pages, want):
    """The split comes from the page table's shape alone (the host never
    reads kv_lens): whole pages of about SPLIT_KEYS keys over its width."""
    n_split, split_keys = PA.split_plan(page_size, max_pages)
    assert (n_split, split_keys) == want
    assert split_keys % page_size == 0 and n_split * split_keys >= max_pages * page_size


@pytest.mark.parametrize("q_max,group,want", [(1, 1, 1), (1, 3, 4), (1, 4, 4), (2, 4, 8),
                                              (1, 8, 8), (512, 1, 8), (512, 4, 8)])
def test_query_tile_holds_a_decode_rows_vectors(q_max, group, want):
    assert PA.query_tile(q_max, group) == want


def test_interleave_split_roundtrip_matches_jax():
    from repro.kernels.paged_attention import interleave_kv as jax_interleave

    rng = np.random.default_rng(3)
    k = rng.standard_normal((5, 3, 4)).astype(np.float32)
    v = rng.standard_normal((5, 3, 4)).astype(np.float32)
    fused = PA.interleave_kv(torch.tensor(k), torch.tensor(v))
    assert fused.shape == (5, 6, 4)
    np.testing.assert_array_equal(fused.numpy(),
                                  np.asarray(jax_interleave(jnp.asarray(k), jnp.asarray(v))))
    k2, v2 = PA.split_kv(fused)
    np.testing.assert_array_equal(k2.numpy(), k)
    np.testing.assert_array_equal(v2.numpy(), v)


def test_wrapper_takes_the_plain_version_only_on_cpu():
    q, pages, table, ql, kl = _case([2], [5], H=2, Kv=1, hd=32, ps=4)
    args = [torch.tensor(a) for a in (q, pages, table, ql, kl)]
    assert PA.paged_attention_blocked.launches == 0
    # pages_per_step is a TPU DMA knob: accepted and ignored
    a = PA.paged_attention_blocked(*args, pages_per_step=4)
    torch.testing.assert_close(a, PA.paged_attention_blocked_plain(*args), rtol=0, atol=0)
    assert PA.paged_attention_blocked.launches == 0
    with pytest.raises(ValueError, match="no kernel for device"):
        PA.paged_attention_blocked(*[t.to("meta") for t in args])



BAD_ARGS = {
    "float64": lambda q, p, t, ql, kl: (q.double(), p.double(), t, ql, kl),
    "mixed_dtypes": lambda q, p, t, ql, kl: (q.bfloat16(), p, t, ql, kl),
    "kv_head_dim_differs": lambda q, p, t, ql, kl: (q, p[..., :16].contiguous(), t, ql, kl),
    "heads_not_multiple_of_kv": lambda q, p, t, ql, kl: (q[:, :, :3].contiguous(), p, t,
                                                         ql, kl),
    "table_rows": lambda q, p, t, ql, kl: (q, p, t[:1], ql, kl),
    "lengths": lambda q, p, t, ql, kl: (q, p, t, ql[:1], kl),
    "non_contiguous_q": lambda q, p, t, ql, kl: (q.transpose(0, 1).contiguous()
                                                 .transpose(0, 1), p, t, ql, kl),
}


@pytest.mark.parametrize("what", sorted(BAD_ARGS))
def test_wrapper_rejects_what_the_kernel_does_not_take(what):
    args = [torch.tensor(a) for a in _case([2, 1], [5, 3], H=4, Kv=2, hd=32, ps=4)]
    with pytest.raises((TypeError, ValueError)):
        PA.paged_attention_blocked(*BAD_ARGS[what](*args))


@pytest.mark.parametrize("check", ["cpu_serves_hd16_like_pallas", "cuda_refusal_names_head_dims"])
def test_head_dim_gate_is_the_cuda_kernels_alone(check):
    """A head dim without a CUDA instance is refused on the card only: the
    CPU serves hd 16 equal to the Pallas kernel, and ``cuda_refusal`` names
    the kernel's head dims for 16 and 48 and passes 64 and 96."""
    if check == "cpu_serves_hd16_like_pallas":
        q_lens, kv_lens = [2, 1], [5, 3]
        q, pages, table, ql, kl = _case(q_lens, kv_lens, H=4, Kv=2, hd=16, ps=4)
        ours = _port(q, pages, table, ql, kl).numpy()
        theirs = jax_paged(jnp.asarray(q), jnp.asarray(pages), jnp.asarray(table),
                           jnp.asarray(ql), jnp.asarray(kl), interpret=True)
        np.testing.assert_allclose(_real_rows(ours, q_lens), _real_rows(theirs, q_lens),
                                   atol=ATOL, rtol=0)
    else:
        for hd in (16, 48):
            why = PA.cuda_refusal(hd)
            assert why is not None and str(PA._HEAD_DIMS) in why and str(hd) in why
        assert PA.cuda_refusal(64) is None and PA.cuda_refusal(96) is None
