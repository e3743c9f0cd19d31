"""Port estimator and prefill planner against the JAX estimation pass.

The port walks an aten graph where JAX walks a jaxpr, so peaks are held to
the same shape, not the same bytes: each candidate's peak within a factor
of 2 of JAX's at gpt-paper's full width.  Where both graphs have the same
ops (a chain of elementwise ops after a matmul) the peaks agree exactly.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import estimation as JE
from repro.core import graph as JG
from repro_torch.configs import get_config
from repro_torch.core import estimation as E
from repro_torch.core import graph as G
from repro_torch.core import stats

torch.set_num_threads(2)


@pytest.mark.parametrize("max_len", [256, 1024])
def test_candidate_peaks_within_2x_of_jax(max_len):
    cfg = get_config("gpt-paper").with_(dtype="float32")
    ours = E.plan_prefill_chunk(cfg, budget=0.5, max_len=max_len)
    theirs = JE.plan_prefill_chunk(jax_config("gpt-paper").with_(dtype="float32"),
                                   budget=0.5, max_len=max_len)
    assert list(ours.candidate_peaks) == list(theirs.candidate_peaks)
    ratios = {c: ours.candidate_peaks[c] / theirs.candidate_peaks[c]
              for c in ours.candidate_peaks}
    print(f"gpt-paper f32 max_len {max_len} port/JAX peak ratios:",
          {c: round(r, 3) for c, r in ratios.items()},
          f"chunk port {ours.chunk} JAX {theirs.chunk}")
    assert all(0.5 <= r <= 2.0 for r in ratios.values()), ratios
    assert ours.fits and ours.peak_bytes <= ours.budget_bytes
    assert ours.baseline_peak_bytes == ours.candidate_peaks[max_len]


def test_tighter_budget_never_plans_a_larger_chunk():
    cfg = get_config("gpt-paper").reduced().with_(dtype="float32")
    plans = [E.plan_prefill_chunk(cfg, budget=b, max_len=128)
             for b in (1.0, 0.75, 0.5, 0.35, 0.3, 0.1)]
    chunks = [p.chunk for p in plans]
    assert chunks == sorted(chunks, reverse=True), chunks
    assert chunks[0] == 128 and chunks[-1] == 8
    for p in plans:
        satisfiable = p.budget_bytes >= min(p.candidate_peaks.values())
        assert p.fits == satisfiable
        if p.fits:
            assert p.peak_bytes <= p.budget_bytes
    assert plans[-2].fits and not plans[-1].fits
    # > 1.0 is bytes: a budget between two candidates' peaks picks the lower
    peaks = plans[0].candidate_peaks
    between = (peaks[32] + peaks[64]) // 2
    p = E.plan_prefill_chunk(cfg, budget=float(between), max_len=128)
    assert (p.chunk, p.budget_bytes, p.fits) == (32, between, True)


def test_estimate_memory_counts_calls_and_traces_nothing_real():
    cfg = get_config("gpt-paper").reduced().with_(dtype="float32")
    before = stats.snapshot()
    g = E._prefill_step_graph(cfg, 16, 64)
    prof = E.estimate_memory(g)
    d = stats.delta(before)
    assert d["trace_calls"] == 1 and d["estimate_calls"] == 1
    assert prof.peak_bytes == max(prof.per_node_bytes) > 0
    assert len(prof.per_node_bytes) == len(g.nodes)
    # the block's weights are inputs, split off and never in the peak
    n_weights = sum(n.meta["val"].numel() for n in g.weight_invars)
    assert len(g.weight_invars) == 10  # ln1 w/b, ln2 w/b, wq wk wv wo, w_in w_out
    assert prof.weight_bytes == 4 * n_weights > 0
    assert all(n.meta["val"].device.type == "meta" for n in g.invars)


def test_elementwise_chain_peak_equals_jax():
    """x @ w, then tanh, then a scale: the same three ops in both graphs."""
    def ours(w, x):
        return torch.tanh(x @ w) * 2.0

    def theirs(w, x):
        return jnp.tanh(x @ w) * 2.0

    meta = torch.device("meta")
    g, _ = G.trace(ours, (torch.empty(64, 96, device=meta), torch.empty(32, 64, device=meta)))
    jg, _ = JG.trace(theirs, (jax.ShapeDtypeStruct((64, 96), jnp.float32),
                              jax.ShapeDtypeStruct((32, 64), jnp.float32)),
                     weight_argnums=(0,))
    p, jp = E.estimate_memory(g), JE.estimate_memory(jg)
    assert p.peak_bytes == jp.peak_bytes == 2 * 32 * 96 * 4
    assert p.weight_bytes == jp.weight_bytes == 64 * 96 * 4
    assert p.io_bytes == jp.io_bytes


# ---------------------------------------------------------------------------
# The cases of tests/test_core_estimation.py, each against the JAX estimator
# on the same shapes.  Band: port peak / JAX peak.  Equal where both graphs
# hold the same ops; the scan case is the one gap: the port's loop is
# unrolled into aten ops, while the JAX scan equation also charges its
# carry (1 KiB), so the port's peak is 1024 B lower (66,048 against 67,072).
# ---------------------------------------------------------------------------

def _chain(x):
    return (x * 2.0) + 1.0


def _fanout(x):
    y = x * 2.0
    return torch.exp(y) + torch.tanh(y) + y


def _jfanout(x):
    y = x * 2.0
    return jnp.exp(y) + jnp.tanh(y) + y


def _scan(x):
    c = x
    for _ in range(4):
        c = torch.outer(c, c).sum(0) * 0.01
    return c


def _jscan(x):
    def body(c, _):
        return jnp.sum(jnp.outer(c, c), axis=0) * 0.01, None

    return jax.lax.scan(body, x, None, length=4)[0]


REF_CASES = {
    # name: (port fn, JAX fn, input shapes, weight argnums, band, peak at least)
    "simple_chain": (_chain, _chain, [(1024,)], (), (1.0, 1.0), 2 * 4096),
    "fanout_keeps_live": (_fanout, _jfanout, [(256,)], (), (1.0, 1.0), 3 * 1024),
    "weights_excluded": (lambda w, x: x @ w, lambda w, x: x @ w, [(512, 512), (4, 512)], (0,),
                         (1.0, 1.0), 4 * 512 * 4),
    "widest_intermediate": (lambda x: torch.einsum("i,j->ij", x, x).sum(0),
                            lambda x: jnp.sum(jnp.einsum("i,j->ij", x, x), axis=0),
                            [(256,)], (), (1.0, 1.0), 256 * 256 * 4),
    "scan_recursion": (_scan, _jscan, [(128,)], (), (0.98, 1.0), 128 * 128 * 4),
}


@pytest.mark.parametrize("name", list(REF_CASES))
def test_reference_estimation_cases_within_band(name):
    fn, jfn, shapes, wn, (lo, hi), least = REF_CASES[name]
    meta = torch.device("meta")
    g, _ = G.trace(fn, [torch.empty(s, device=meta) for s in shapes], weight_argnums=wn)
    jg, _ = JG.trace(jfn, [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes],
                     weight_argnums=wn)
    p, jp = E.estimate_memory(g), JE.estimate_memory(jg)
    ratio = p.peak_bytes / jp.peak_bytes
    print(f"{name}: port {p.peak_bytes} B, JAX {jp.peak_bytes} B, ratio {ratio:.4f}")
    assert lo <= ratio <= hi, (p.peak_bytes, jp.peak_bytes)
    assert p.peak_bytes >= least
    assert p.weight_bytes == jp.weight_bytes
    if name == "weights_excluded":
        assert p.weight_bytes == 512 * 512 * 4 and p.peak_bytes < p.weight_bytes
    if name == "widest_intermediate":
        assert G.op_name(g.nodes[p.peak_node]) in ("mul", "sum", "mm", "bmm")
