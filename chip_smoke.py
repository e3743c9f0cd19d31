#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (one compiler per source, in parallel) and drives the port's
three paths, two at gpt-paper's full width and one at minitron-4b's:

* serving: the paged engine, its kernel held against its plain version at
  the serving shapes, the served logits against the dense forward;
* the AutoChunk compiler: the 12-layer bf16 forward of 8192 tokens compiled
  at a 0.2 activation budget, once with the computed-mask attention kernel
  and once with ``mask_mode="bool"`` (the bool-mask kernel); predicted and
  measured activation peaks and times of the chunked and unchunked
  forwards, and chunked against unchunked logits in float32.
  Both attention kernels are then held against their plain versions at the
  compiled chunk shape (plus a window and a GQA case);
* per-block AutoChunk inside the model forward: minitron-4b's 32-layer bf16
  forward of 8192 tokens with ``autochunk_budget=0.04``, one dense block
  compiled at the first layer and replayed for the other 31, its attention
  on ``computed_attention`` and its SwiGLU MLP on ``chunked_ffn``; the
  block's predicted and measured activation peaks, ``computed_attention``
  held against its plain version on layer 0's own inputs and at the plan's
  chunk shape and offsets, the whole forward's peaks and times, chunked
  against unchunked logits in float32 at 4 layers, and the bf16 logits of
  the same weights against those float32 ones (per block no further than
  1.5 times the unchunked bf16 logits).  ``chunked_ffn`` is then held
  against its plain version at the block's chunk, 2048 and 17 rows, with
  the fused and the separate weights.

Each path runs with the kernels' launch counts zeroed just before and read
just after.  Every kernel is timed beside its bound, its plain version and
the one PyTorch call that computes the same function.  Any failed phase
exits non-zero.  Without a CUDA device, or run from a directory that lacks
the repository's ``src/``, it exits non-zero and prints no result.

The last two lines of standard output are the kernels' JSON line and
``{"ok": true, "device": {...}}``; the card's name and power limit, as
``nvidia-smi`` reports them, come on the line before those.
"""
from __future__ import annotations

import collections
import concurrent.futures
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# Kernel against plain version on real rows: |got - want| <= atol + rtol|want|
# elementwise.  fp32: the two sum in another order and use another exp
# (measured max 6.6e-7).  bf16: both round an f32 result to 8 mantissa bits
# and may land one unit in the last place apart, at most 2^-7 |want|; atol
# covers the f32 differences near zero (measured max 9.8e-4, one unit in the
# last place of a value near 0.2).
TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-3, 2.0 ** -7)}
SERVE = dict(max_seqs=8, max_len=2048, page_size=16, budget=0.5, max_new=32)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ragged_case(torch, *, q_lens, kv_lens, H, Kv, hd, ps, max_len, dtype, seed):
    """Random q and a shuffled page pool holding each row's context."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, q_max = len(q_lens), max(q_lens)
    n_used = [-(-kl // ps) for kl in kv_lens]
    P = sum(n_used) + 1
    max_pages = -(-max_len // ps)
    pages = torch.randn((P, ps, 2 * Kv, hd), generator=g, device="cuda").to(dtype)
    order = torch.randperm(P, generator=g, device="cuda").tolist()
    table = torch.zeros((S, max_pages), dtype=torch.int32)
    for s, n in enumerate(n_used):
        for j in range(n):
            table[s, j] = order.pop()
    q = torch.randn((S, q_max, H, hd), generator=g, device="cuda").to(dtype)
    return (q, pages, table.cuda(), torch.tensor(q_lens, dtype=torch.int32, device="cuda"),
            torch.tensor(kv_lens, dtype=torch.int32, device="cuda"))


def real_rows_err(got, want, q_lens, atol, rtol):
    """Max abs error on real rows, and the largest share of its limit."""
    err = share = 0.0
    for s, n in enumerate(q_lens):
        if n:
            w = want[s, :n].float()
            d = (got[s, :n].float() - w).abs()
            err = max(err, float(d.max()))
            share = max(share, float((d / (atol + rtol * w.abs())).max()))
    return err, share


def work(q_lens, kv_lens, H, Kv, hd, max_pages, itemsize):
    """Bytes the call must move and operations it must do on these inputs."""
    live = [(ql, kl) for ql, kl in zip(q_lens, kv_lens) if ql]
    S, q_max = len(q_lens), max(q_lens)
    nbytes = (sum(ql for ql, _ in live) * H * hd * itemsize     # q: real rows only
              + S * q_max * H * hd * itemsize   # out: padding rows are written as zeros
              + sum(kl for _, kl in live) * 2 * Kv * hd * itemsize  # K and V once
              + S * max_pages * 4 + 2 * S * 4)                   # table, lengths
    # causal: query i of a row sees kv_len - q_len + i + 1 keys; a q.k and a
    # p.v product per key, 2 operations each per head dim
    keys = sum(ql * (kl - ql) + ql * (ql + 1) // 2 for ql, kl in live)
    return nbytes, 4 * H * hd * keys


def time_ms(torch, fn, flush, reps=25):
    """Median of ``reps`` CUDA-event timings, L2 flushed before each run."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# The compiler path: autochunk on gpt-paper with the chunked-attention kernels
# ---------------------------------------------------------------------------

COMPILE = dict(seq_len=8192, budget=0.2,
               # 12 attention stages plus one for the unembed's f32 logits:
               # the default of 12 stages stops one short at this length
               max_stages=16)


def band_pairs(Sq, Skv, q_offset, causal, window):
    """(query, key) pairs a computed-mask row set really attends."""
    pairs = 0
    for a in range(Sq):
        qpos = q_offset + a
        hi = min(qpos, Skv - 1) if causal else Skv - 1
        lo = max(0, qpos - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def attention_case(torch, *, N, group, Sq, Skv, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((N * group, Sq, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((N, Skv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((N, Skv, hd), generator=g, device="cuda").to(dtype)
    return q, k, v


def gpt_attention_cases(chunk, ext):
    """The compiled gpt-paper forward's chunk at its first, middle and last
    offset, plus a window case and a GQA case."""
    offsets = {"first": 0, "mid": (ext - chunk) // 2, "last": ext - chunk}
    cases = [dict(name=f"gpt_{k}", N=12, group=1, hd=64, off=o, window=None)
             for k, o in offsets.items()]
    cases += [dict(name="gpt_window", N=12, group=1, hd=64, off=offsets["mid"], window=1024),
              dict(name="gqa_last", N=8, group=4, hd=128, off=offsets["last"], window=None)]
    return [dict(c, Sq=chunk, Skv=ext) for c in cases]


def check_attention_kernels(torch, CA, cases, errs=None):
    """Both chunked-attention kernels against their plain versions on the
    card at each case's shape, in fp32 and bf16, on random inputs.  Returns
    max errors per (kernel, dtype), merged into ``errs``."""
    errs = {} if errs is None else errs
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for i, c in enumerate(cases):
            chunk, ext = c["Sq"], c["Skv"]
            q, k, v = attention_case(torch, N=c["N"], group=c["group"], Sq=chunk, Skv=ext,
                                     hd=c["hd"], dtype=dtype, seed=100 + i)
            scale = c["hd"] ** -0.5
            qpos = c["off"] + torch.arange(chunk, device="cuda")[:, None]
            kpos = torch.arange(ext, device="cuda")[None, :]
            band = kpos <= qpos
            if c["window"]:
                band = band & (qpos - kpos < c["window"])
            # the masked kernel gets the same band as a bool mask, and for
            # gpt heads also a random per-head mask with an empty row
            masks = [("band", band[None])]
            if c["group"] == 1 and c["name"] == "gpt_mid":
                m = torch.rand((c["N"], chunk, ext), device="cuda") < 0.5
                m[:, 7] = False
                masks.append(("random", m))
            runs = [("computed_attention", c["name"],
                     lambda: CA.computed_attention(q, k, v, c["off"], scale=scale,
                                                   window=c["window"], group=c["group"]),
                     lambda: CA.computed_attention_plain(q, k, v, c["off"], scale=scale,
                                                         window=c["window"],
                                                         group=c["group"]))]
            for mname, m in masks:
                runs.append(("masked_attention", f"{c['name']}_{mname}",
                             lambda m=m: CA.masked_attention(q, k, v, m, scale=scale,
                                                             group=c["group"]),
                             lambda m=m: CA.masked_attention_plain(q, k, v, m, scale=scale,
                                                                   group=c["group"])))
            for kname, label, kernel, plain in runs:
                err = hold(torch, kname, f"{label} {dt_name} Sq={chunk} Skv={ext}"
                           f" H={c['N'] * c['group']} Kv={c['N']} hd={c['hd']}"
                           f" q_offset={c['off']}", kernel, plain, TOL[dt_name])
                errs[(kname, dt_name)] = max(errs.get((kname, dt_name), 0.0), err)
    return errs


def hold(torch, kname, label, kernel, plain, tol):
    """One kernel call against its plain version, elementwise within
    ``atol + rtol |want|``; prints and returns the max abs error."""
    atol, rtol = tol
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    err = float(d.max())
    share = float((d / (atol + rtol * want.float().abs())).max())
    check(bool(torch.isfinite(got).all()), f"{kname} {label}: non-finite")
    print(f"[kernel] {kname} {label}: max_abs_err {err:.3e}, {share:.3f} of the limit"
          f" {atol:g} + {rtol:g}|want|")
    check(share <= 1.0, f"{kname} {label} err {err}")
    return err


def compile_forward(torch, cfg, model, batch, *, mask_mode):
    """Trace, search and compile the forward; returns (compiled, planned,
    host seconds of each stage)."""
    from repro_torch.core import ChunkConfig, autochunk
    from repro_torch.models import model as M

    cf = autochunk(M.logits_fn(model), ChunkConfig(
        budget_ratio=COMPILE["budget"], max_stages=COMPILE["max_stages"],
        mask_mode=mask_mode))
    params = dict(model.named_parameters())
    t0 = time.perf_counter()
    traced = cf.trace(params, batch)
    t1 = time.perf_counter()
    planned = traced.search()
    t2 = time.perf_counter()
    compiled = planned.compile()
    t3 = time.perf_counter()
    return compiled, planned, (t1 - t0, t2 - t1, t3 - t2)


def dispatched_loops(planned):
    from repro_torch.core.lowering import is_chunk_loop

    return [n for n in planned.graph.nodes if is_chunk_loop(n) and n.params["dispatches"]]


def measure_forward(torch, fn, args):
    """(output, activation peak bytes, CUDA-event ms) of one call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn(*args)
    b.record()
    b.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return out, peak, a.elapsed_time(b)


def run_compiled_forward(torch, CA, stats, M, cfg, card, *, mask_mode):
    """The port's compiler path at full width: compile, drive it with the
    kernel counts zeroed just before and read just after, check it."""
    import numpy as np

    kname = "computed_attention" if mask_mode == "auto" else "masked_attention"
    kernel = getattr(CA, kname)
    S = COMPILE["seq_len"]
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(3), device="cuda")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)), device="cuda")}
    before = stats.snapshot()
    compiled, planned, (t_trace, t_search, t_compile) = compile_forward(
        torch, cfg, model, batch, mask_mode=mask_mode)
    d = stats.delta(before)
    r = compiled.result
    loops = dispatched_loops(planned)
    expected = sum(n.params["n_iters"] for n in loops)
    chunks = sorted({n.params["c"] for n in loops})
    print(f"[compile] gpt-paper L={cfg.n_layers} d={cfg.d_model} {cfg.dtype} S={S}"
          f" budget {COMPILE['budget']} mask_mode={mask_mode}: host seconds trace"
          f" {t_trace:.2f}, search {t_search:.2f}, compile {t_compile:.2f};"
          f" {len(r.plan)} stages; predicted peak {r.baseline_peak} B ->"
          f" {r.final_peak} B (budget {r.budget_bytes} B,"
          f" {r.reduction:.1%} reduction); dispatch hits {d['kernel_dispatch_hits']}"
          f" (computed mask {d['kernel_dispatch_computed_mask']}), misses"
          f" {d['kernel_dispatch_misses']}; attention chunks {chunks}")
    for line in r.report().splitlines()[6:]:
        print(f"[compile] {line.strip()}")
    check(d["kernel_dispatch_hits"] == cfg.n_layers,
          f"{d['kernel_dispatch_hits']} dispatch hits, want {cfg.n_layers}")
    if mask_mode == "auto":
        check(d["kernel_dispatch_computed_mask"] == cfg.n_layers, "not every mask is a band")
    fn = M.logits_fn(model)
    params = dict(model.named_parameters())
    with torch.no_grad():
        fn(params, batch)                                  # warm-ups
        compiled(params, batch)
        y0, peak0, ms0 = measure_forward(torch, fn, (params, batch))
        del y0
        CA.computed_attention.launches = CA.masked_attention.launches = 0
        y1, peak1, ms1 = measure_forward(torch, compiled, (params, batch))
        launches = kernel.launches
    check(launches == expected, f"{kname} launched {launches} times, want {expected}")
    check(launches == cfg.n_layers * (expected // cfg.n_layers), "uneven chunk counts")
    check(bool(torch.isfinite(y1[..., :cfg.vocab_size]).all()), "non-finite chunked logits")
    print(f"[forward] {mask_mode}: activation peak unchunked {peak0} B (predicted"
          f" {r.baseline_peak} B), chunked {peak1} B (predicted {r.final_peak} B,"
          f" budget {r.budget_bytes} B): measured reduction {1 - peak1 / peak0:.1%};"
          f" time unchunked {ms0:.2f} ms, chunked {ms1:.2f} ms; {kname} launches"
          f" {launches} = {cfg.n_layers} layers x {expected // cfg.n_layers} chunks; {card}")
    out = dict(launches=launches, chunk=chunks[0], peak0=peak0, peak1=peak1, ms0=ms0, ms1=ms1,
               pred0=r.baseline_peak, pred1=r.final_peak)
    del y1, compiled, planned, model
    return out


def check_forward_fp32(torch, M, cfg, *, mask_mode):
    """Chunked against unchunked logits in float32, at the full length: at
    2048 tokens the unembed's 413 MB of f32 logits outweigh each layer's
    attention (12 S^2 f32 grows past 50432 S at S ~ 4200), so the search
    chunks no attention site there and the kernels would go unchecked."""
    import numpy as np

    cfg32 = cfg.with_(dtype="float32")
    S = COMPILE["seq_len"]
    model = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(4), device="cuda")
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)), device="cuda")}
    compiled, planned, _ = compile_forward(torch, cfg32, model, batch, mask_mode=mask_mode)
    n_dispatched = len(dispatched_loops(planned))
    check(n_dispatched == cfg.n_layers, f"fp32: {n_dispatched} attention sites dispatched")
    params = dict(model.named_parameters())
    with torch.no_grad():
        y1 = compiled(params, batch)
        y0 = M.logits_fn(model)(params, batch)
    err = float((y1[..., :cfg.vocab_size] - y0[..., :cfg.vocab_size]).abs().max())
    print(f"[forward] {mask_mode}: fp32 S={S}, {len(compiled.result.plan)} stages,"
          f" {n_dispatched} attention sites dispatched: chunked vs unchunked logits"
          f" max_abs_err {err:.3e} (limit 1e-3)")
    check(err <= 1e-3, f"fp32 chunked logits differ by {err}")
    return err


def time_attention_kernels(torch, F, CA, chunk, ext, flush, card, *, N=12, group=1, hd=64,
                           names=("computed_attention", "masked_attention")):
    """Each kernel at one chunk shape (by default the compiled gpt-paper
    forward's: gpt-paper heads, the last chunk, which sees every key) in
    bf16, beside its bound, its plain version and SDPA with the same mask."""
    H, off = N * group, ext - chunk
    q, k, v = attention_case(torch, N=N, group=group, Sq=chunk, Skv=ext, hd=hd,
                             dtype=torch.bfloat16, seed=7)
    scale = hd ** -0.5
    qpos = off + torch.arange(chunk, device="cuda")[:, None]
    mask = torch.arange(ext, device="cuda")[None, :] <= qpos
    q4, k4, v4 = q[None], k[None], v[None]
    io = 2 * (2 * H * chunk * hd + 2 * N * ext * hd)      # q, out, K, V in bf16
    runs = {
        "computed_attention": (
            H * band_pairs(chunk, ext, off, True, None), io,
            lambda: CA.computed_attention(q, k, v, off, scale=scale, group=group),
            lambda: CA.computed_attention_plain(q, k, v, off, scale=scale, group=group)),
        "masked_attention": (
            H * chunk * ext, io + chunk * ext,
            lambda: CA.masked_attention(q, k, v, mask[None], scale=scale, group=group),
            lambda: CA.masked_attention_plain(q, k, v, mask[None], scale=scale, group=group)),
    }
    timed = {}
    for name in names:
        pairs, nbytes, kernel, plain = runs[name]
        ops = 4 * pairs * hd
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
        t = timed[name] = {
            "ms": time_ms(torch, kernel, flush),
            "plain_ms": time_ms(torch, plain, flush),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=scale, enable_gqa=group > 1), flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "sq": chunk, "skv": ext, "q_offset": off, "heads": H, "kv_heads": N, "hd": hd,
            "bytes": nbytes, "operations": ops,
        }
        print(f"[time] {name} bf16 (H={H} Kv={N} Sq={chunk} Skv={ext} hd={hd}"
              f" q_offset={off}): kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms"
              f" ({t['bound_by']}; {nbytes} B, {ops} ops), plain {t['plain_ms']:.4f} ms,"
              f" SDPA {t['library_ms']:.4f} ms, {t['bound_ms'] / t['ms']:.1%} of bound; {card}")
    return timed


# ---------------------------------------------------------------------------
# The per-block path: minitron-4b's forward, one dense block compiled by
# AutoChunk and replayed for every layer, with the chunked FFN kernel
# ---------------------------------------------------------------------------

BLOCK = dict(arch="minitron-4b", seq_len=8192,
             # the block's plan chunks attention and the MLP at this budget
             budget=0.04,
             # depth of the float32 check: every layer replays one plan
             fp32_layers=4)
FFN_ROWS = (2048, 17)        # checked beside the block's own chunk


def block_loops(planned):
    """{dispatch kind: (rows per chunk, loop trips)} of a planned block."""
    from repro_torch.core.lowering import is_chunk_loop

    return {d.kind: (n.params["c"], n.params["n_iters"])
            for n in planned.graph.nodes if is_chunk_loop(n) for d in n.params["dispatches"]}


def block_batch(torch, cfg, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (1, BLOCK["seq_len"])),
                                   device="cuda")}


def max_logit_err(y1, y0, vocab):
    """max |y1 - y0| over the real vocabulary, 1024 rows at a time."""
    return max(float((y1[0, i:i + 1024, :vocab].float() - y0[0, i:i + 1024, :vocab].float())
                     .abs().max()) for i in range(0, y0.shape[1], 1024))


def capture_calls(torch, module, name, fn):
    """Run ``fn`` with ``module.<name>`` wrapped so that every call's
    arguments are kept (tensors copied); the wrapped kernel runs as usual.
    The wrapper counts its launches on the module's name, so the spy holds
    the count while it stands there."""
    wrapped, calls = getattr(module, name), []

    def spy(*args, **kw):
        calls.append(([a.clone() if isinstance(a, torch.Tensor) else a for a in args], kw))
        return wrapped(*args, **kw)

    spy.launches = wrapped.launches
    setattr(module, name, spy)
    try:
        with torch.no_grad():
            fn()
    finally:
        setattr(module, name, wrapped)
        wrapped.launches = spy.launches
    return calls


def check_block_attention(torch, CA, calls, errs):
    """``computed_attention`` against its plain version at what the block's
    plan gives it: first on layer 0's own inputs, chunk by chunk, in the
    dtype the path runs; then on random inputs at the same shape (heads,
    group, chunk, keys) and at its first and last offset, fp32 and bf16."""
    offs = []
    for i, ((q, k, v, off), kw) in enumerate(calls):
        dt_name = str(q.dtype).removeprefix("torch.")
        err = hold(torch, "computed_attention",
                   f"block chunk {i} of layer 0 {dt_name} Sq={q.shape[1]} Skv={k.shape[1]}"
                   f" H={q.shape[0]} Kv={k.shape[0]} hd={q.shape[2]} q_offset={off}",
                   lambda: CA.computed_attention(q, k, v, off, **kw),
                   lambda: CA.computed_attention_plain(q, k, v, off, **kw), TOL[dt_name])
        errs[("computed_attention", dt_name)] = max(
            errs.get(("computed_attention", dt_name), 0.0), err)
        offs.append(off)
    (q, k, _, _), kw = calls[0]
    shape = dict(N=k.shape[0], group=kw["group"], hd=q.shape[2], Sq=q.shape[1],
                 Skv=k.shape[1], window=kw["window"])
    check(kw["causal"] and shape["group"] * shape["N"] == q.shape[0],
          f"block attention call {kw}")
    check_attention_kernels(torch, CA, [dict(shape, name="block_first", off=min(offs)),
                                        dict(shape, name="block_last", off=max(offs))], errs)
    return dict(calls=len(calls), dtype=str(q.dtype).removeprefix("torch."),
                q_offsets=offs, **shape)


def run_block_forward(torch, CA, CF, stats, M, card, attn_errs):
    """The per-block path at full width: first forward (one search at layer
    0, 31 replays), the plan replayed once more to read its loops, the block's
    peaks on layer 0, then the whole forward unchunked and per block with the
    kernel counts zeroed just before and read just after."""
    from repro_torch.configs import get_config

    cfg = get_config(BLOCK["arch"])                      # bf16, 32 layers, full width
    cfg_ac = cfg.with_(autochunk_budget=BLOCK["budget"])
    S, L = BLOCK["seq_len"], cfg.n_layers
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(5), device="cuda")
    batch = block_batch(torch, cfg, 5)
    M._AC_CACHE.clear()
    before = stats.snapshot()
    t0 = time.perf_counter()
    y = M.forward(cfg_ac, model, batch)[0]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    d = stats.delta(before)
    del y
    (cf,) = M._AC_CACHE.values()
    r = cf.autochunk_result
    check(cf.counters["compiles"] == 1 and cf.counters["shape_hits"] == L - 1,
          f"first forward: {cf.stats()}, want 1 compile and {L - 1} replays")
    check(d["plan_bucket_misses"] == 1, f"{d['plan_bucket_misses']} bucket misses, want 1")
    check(d["kernel_dispatch_hits"] == 2 and d["kernel_dispatch_computed_mask"] == 1
          and d["kernel_dispatch_misses"] == 0,
          f"dispatch hits {d['kernel_dispatch_hits']} (computed"
          f" {d['kernel_dispatch_computed_mask']}), misses {d['kernel_dispatch_misses']};"
          " want attention (computed mask) and SwiGLU, no miss")
    print(f"[block] minitron-4b L={L} d={cfg.d_model} f={cfg.d_ff} {cfg.dtype} S={S} budget"
          f" {BLOCK['budget']}: first forward {first_s:.2f}s, one block compile (host seconds"
          f" trace {r.trace_s:.2f}, search {r.search_s:.2f}, compile"
          f" {r.elapsed_s - r.trace_s - r.search_s:.2f}; {d['search_passes']} search passes),"
          f" {cf.counters['shape_hits']} replays; predicted block peak {r.baseline_peak} B ->"
          f" {r.final_peak} B (budget {r.budget_bytes} B, {r.reduction:.1%} reduction);"
          f" dispatch hits {d['kernel_dispatch_hits']} (computed mask"
          f" {d['kernel_dispatch_computed_mask']}), misses {d['kernel_dispatch_misses']}")
    for line in r.report().splitlines()[6:]:
        print(f"[block] {line.strip()}")

    # the bucket's plan replayed on layer 0: its loops, with no search
    p0 = M._index_tree(model["blocks"], 0)
    h0 = M.embed_inputs(cfg, model, batch)[0]
    before = stats.snapshot()
    loops = block_loops(cf.trace(p0, h0).search())
    check(stats.delta(before)["search_passes"] == 0, "the replay searched")
    check(set(loops) == {"attention", "swiglu"}, f"dispatched loops {loops}")
    print(f"[block] loops: attention {loops['attention'][1]} chunks of"
          f" {loops['attention'][0]} rows, SwiGLU {loops['swiglu'][1]} chunks of"
          f" {loops['swiglu'][0]} rows")

    # one block's activation peak, unchunked and chunked, on layer 0
    def block(p, x):
        return M.dense_block_full(cfg, p, x, window=None, causal=cfg.causal)

    with torch.no_grad():
        block(p0, h0)
        _, bpeak0, bms0 = measure_forward(torch, block, (p0, h0))
        _, bpeak1, bms1 = measure_forward(torch, cf, (p0, h0))
    print(f"[block] layer 0 activation peak: unchunked {bpeak0} B (predicted"
          f" {r.baseline_peak} B, {bpeak0 / r.baseline_peak:.4f}x), chunked {bpeak1} B"
          f" (predicted {r.final_peak} B, {bpeak1 / r.final_peak:.4f}x); time unchunked"
          f" {bms0:.2f} ms, chunked {bms1:.2f} ms; {card}")
    check(abs(bpeak1 - r.final_peak) <= 0.05 * r.final_peak,
          f"chunked block peak {bpeak1} B is not within 5% of the predicted {r.final_peak} B")

    # the attention kernel at the plan's own chunk shape and offsets
    calls = capture_calls(torch, CA, "computed_attention", lambda: cf(p0, h0))
    check(len(calls) == loops["attention"][1],
          f"{len(calls)} attention calls in one block, want {loops['attention'][1]}")
    attn_check = check_block_attention(torch, CA, calls, attn_errs)
    del calls

    # the whole forward, unchunked and per block
    def unchunked():
        return M.forward(cfg, model, batch)[0]

    def per_block():
        return M.forward(cfg_ac, model, batch)[0]

    unchunked()
    y0, peak0, ms0 = measure_forward(torch, unchunked, ())
    hits = cf.counters["shape_hits"]
    before = stats.snapshot()
    CA.computed_attention.launches = CF.chunked_ffn.launches = 0
    y1, peak1, ms1 = measure_forward(torch, per_block, ())
    n_ffn, n_attn = CF.chunked_ffn.launches, CA.computed_attention.launches
    d = stats.delta(before)
    check(d["search_passes"] == 0 and cf.counters["shape_hits"] - hits == L,
          f"second forward: {d['search_passes']} search passes,"
          f" {cf.counters['shape_hits'] - hits} replays")
    check(n_ffn == L * loops["swiglu"][1],
          f"chunked_ffn launched {n_ffn} times, want {L} x {loops['swiglu'][1]}")
    check(n_attn == L * loops["attention"][1],
          f"computed_attention launched {n_attn} times, want {L} x {loops['attention'][1]}")
    check(bool(torch.isfinite(y1[..., :cfg.vocab_size]).all()), "non-finite per-block logits")
    bf16_err = max_logit_err(y1, y0, cfg.vocab_size)
    print(f"[forward] minitron-4b per-block: whole-forward peak unchunked {peak0} B, per"
          f" block {peak1} B (the {S} x {cfg.vocab_padded} logits set both); time"
          f" unchunked {ms0:.2f} ms, per block {ms1:.2f} ms; chunked_ffn launches {n_ffn} ="
          f" {L} layers x {loops['swiglu'][1]} chunks, computed_attention launches {n_attn}"
          f" = {L} layers x {loops['attention'][1]} chunks; bf16 logits max |delta| vs"
          f" unchunked {bf16_err:.3e} (bounded against float32 at 4 layers below); {card}")
    del y0, y1
    trace = device_time_split(torch, per_block, card)
    del model, p0, h0
    M._AC_CACHE.clear()
    return dict(launches=n_ffn, attention_launches=n_attn, chunk=loops["swiglu"][0],
                attention_chunk=loops["attention"][0], attention_check=attn_check,
                bf16_logits_err=bf16_err, stages=len(r.plan),
                pred_block0=r.baseline_peak, pred_block1=r.final_peak, block_peak0=bpeak0,
                block_peak1=bpeak1, peak0=peak0, peak1=peak1, ms0=ms0, ms1=ms1,
                trace_s=r.trace_s, search_s=r.search_s, device_ms=trace)


def device_time_split(torch, fn, card):
    """Device time of one call by kernel name under ``torch.profiler``
    (informational; the profiler's host overhead stretches the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    del out
    device_us = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device_us[e.name] += e.time_range.elapsed_us()
    busy = sum(device_us.values()) / 1e3
    if busy == 0:
        print("[trace] torch.profiler recorded no device time: the per-block forward's"
              " split is not measured")
        return {}
    split = {"busy": busy}
    for key, pats in (("chunked_ffn", ("ffn_", "cast_bf16")),
                      ("computed_attention", ("chunk_attention",)),
                      ("matmul", ("gemm", "nvjet"))):
        split[key] = sum(us for n, us in device_us.items()
                         if any(p in n for p in pats)) / 1e3
    print(f"[trace] per-block forward on the device: busy {busy:.2f} ms; chunked_ffn kernels"
          f" {split['chunked_ffn']:.2f} ms, computed_attention {split['computed_attention']:.2f}"
          f" ms, cuBLAS products {split['matmul']:.2f} ms; {card}")
    for n, us in device_us.most_common(8):
        print(f"[trace]   {us / 1e3:10.3f} ms  {n[:100]}")
    return split


def check_block_forward_fp32(torch, CF, stats, M):
    """Chunked against unchunked logits in float32 at full width and S 8192,
    depth cut to 4 layers (each layer replays the one plan).  Then the same
    weights rounded to bf16: the per-block bf16 logits may stray from the
    float32 ones no further than 1.5 times the unchunked bf16 logits do."""
    from repro_torch.configs import get_config

    cfg = get_config(BLOCK["arch"]).with_(dtype="float32", n_layers=BLOCK["fp32_layers"])
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(6), device="cuda")
    batch = block_batch(torch, cfg, 6)
    M._AC_CACHE.clear()
    with torch.no_grad():
        y0 = M.forward(cfg, model, batch)[0]
        before = stats.snapshot()
        ffn0 = CF.chunked_ffn.launches
        y1 = M.forward(cfg.with_(autochunk_budget=BLOCK["budget"]), model, batch)[0]
    d = stats.delta(before)
    check(d["kernel_dispatch_hits"] == 2 and d["kernel_dispatch_computed_mask"] == 1
          and d["kernel_dispatch_misses"] == 0, f"fp32 dispatch: {d}")
    check(CF.chunked_ffn.launches > ffn0, "fp32: chunked_ffn never launched")
    err = max_logit_err(y1, y0, cfg.vocab_size)
    (cf,) = M._AC_CACHE.values()
    print(f"[forward] minitron-4b per-block fp32 L={cfg.n_layers} S={BLOCK['seq_len']}:"
          f" {len(cf.autochunk_result.plan)} stages, attention and SwiGLU dispatched;"
          f" chunked vs unchunked logits max_abs_err {err:.3e} (limit 1e-3)")
    check(err <= 1e-3, f"fp32 per-block logits differ by {err}")
    del y1

    cfg16 = cfg.with_(dtype="bfloat16")
    model.to(torch.bfloat16)
    M._AC_CACHE.clear()
    with torch.no_grad():
        y16 = M.forward(cfg16, model, batch)[0]
        err_u = max_logit_err(y16, y0, cfg.vocab_size)
        del y16
        before = stats.snapshot()
        y16 = M.forward(cfg16.with_(autochunk_budget=BLOCK["budget"]), model, batch)[0]
    d = stats.delta(before)
    check(d["kernel_dispatch_hits"] == 2 and d["kernel_dispatch_misses"] == 0,
          f"bf16 dispatch: {d}")
    err_c = max_logit_err(y16, y0, cfg.vocab_size)
    print(f"[forward] minitron-4b bf16 L={cfg.n_layers} S={BLOCK['seq_len']} against the"
          f" float32 logits of the same weights: unchunked max_abs_err {err_u:.3e}, per"
          f" block {err_c:.3e} ({err_c / err_u:.3f}x; limit 1.5x)")
    check(err_c <= 1.5 * err_u, f"bf16 per-block logits stray {err_c} from float32,"
          f" the unchunked bf16 ones {err_u}")
    del y0, y16, model
    M._AC_CACHE.clear()
    return dict(fp32_logits_err=err, bf16_vs_fp32_unchunked=err_u, bf16_vs_fp32_per_block=err_c)


def ffn_case(torch, c, d, f, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((c, d), generator=g, device="cuda").to(dtype)
    w_in = (torch.randn((d, 2 * f), generator=g, device="cuda") * d ** -0.5).to(dtype)
    wd = (torch.randn((f, d), generator=g, device="cuda") * f ** -0.5).to(dtype)
    return x, w_in, wd


def check_ffn_kernel(torch, CF, cfg, rows):
    """The kernel against its plain version on the card, at minitron's width
    (fused w_in read in place, and separate contiguous weights)."""
    d, f = cfg.d_model, cfg.d_ff
    errs = {}
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for i, c in enumerate(rows):
            x, w_in, wd = ffn_case(torch, c, d, f, dtype, seed=200 + i)
            wu, wg = w_in[:, :f], w_in[:, f:]
            wgc, wuc = wg.contiguous(), wu.contiguous()
            forms = {"fused": lambda: CF.chunked_ffn_fused(x, w_in, wd),
                     "separate": lambda: CF.chunked_ffn(x, wgc, wuc, wd)}
            for form, kernel in forms.items():
                err = hold(torch, "chunked_ffn", f"{form} {dt_name} c={c} d={d} f={f}", kernel,
                           lambda: CF.chunked_ffn_plain(x, wg, wu, wd), TOL[dt_name])
                errs[dt_name] = max(errs.get(dt_name, 0.0), err)
            del x, w_in, wd, wg, wu, wgc, wuc, forms
    return errs


def time_ffn_kernel(torch, F, CF, cfg, c, flush, card):
    """The kernel at the block's chunk in bf16, fused w_in as on the main
    path, beside its bound, its plain version and the eager chain of three
    cuBLAS products and two elementwise kernels (no one PyTorch call
    computes SwiGLU)."""
    d, f = cfg.d_model, cfg.d_ff
    x, w_in, wd = ffn_case(torch, c, d, f, torch.bfloat16, seed=7)
    wu, wg = w_in[:, :f], w_in[:, f:]
    nbytes = (3 * d * f + 2 * c * d) * 2          # weights once, x in, out
    ops = 6 * c * d * f
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    t = {
        "ms": time_ms(torch, lambda: CF.chunked_ffn_fused(x, w_in, wd), flush),
        "plain_ms": time_ms(torch, lambda: CF.chunked_ffn_plain(x, wg, wu, wd), flush),
        "library_ms": time_ms(torch, lambda: (F.silu(x @ wg) * (x @ wu)) @ wd, flush),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "rows": c, "d": d, "f": f, "bytes": nbytes, "operations": ops,
    }
    print(f"[time] chunked_ffn bf16 (c={c} d={d} f={f}, fused w_in): kernel {t['ms']:.4f} ms,"
          f" bound {t['bound_ms']:.4f} ms ({t['bound_by']}; {nbytes} B, {ops} ops), plain"
          f" {t['plain_ms']:.4f} ms, cuBLAS chain {t['library_ms']:.4f} ms,"
          f" {t['bound_ms'] / t['ms']:.1%} of bound; {card}")
    return t


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch; run it from the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    check(Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"),
          f"imported repro_torch from {repro_torch.__file__}, not from {ROOT / 'src'}")
    from repro_torch.configs import get_config
    from repro_torch.core import stats
    from repro_torch.core.estimation import plan_prefill_chunk, prefill_block_step
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import model as M
    from repro_torch.serving import PagedServeEngine, Request

    # ---- 1. device --------------------------------------------------------
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] TF32 off for matmul and cuDNN: float32 products run in full float32")

    # ---- 2. build ---------------------------------------------------------
    # one nvcc per source, all started together
    def timed_build(name):
        t0 = time.perf_counter()
        return build.build(name), time.perf_counter() - t0

    sources = ("paged_attention", "chunked_attention", "chunked_ffn")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(timed_build, sources)))
    for name, (log, seconds) in builds.items():
        print(f"[build] {name}.cu with nvcc in {seconds:.2f}s")
        for line in log.splitlines():
            if "registers" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 3. kernel against its plain version at the serving shapes -------
    cfg = get_config("gpt-paper")                         # bf16, full width
    L_max, ps = SERVE["max_len"], SERVE["page_size"]
    plan = plan_prefill_chunk(cfg, budget=SERVE["budget"], max_len=L_max)
    chunk = plan.chunk
    lens = np.linspace(256, 1024, 8).astype(int).tolist()     # the served prompts
    decode = dict(q_lens=[1] * 8, kv_lens=[2048, 1, 700, 1500, 33, 1024, 1999, 256])
    # a decode step of the serving run, halfway through its new tokens
    serve_decode = dict(q_lens=[1] * 8, kv_lens=[n + SERVE["max_new"] // 2 for n in lens])
    mixed = dict(q_lens=[1, chunk, 1, 1, 1, 1, 1, 0],
                 kv_lens=[300, max(chunk, 1024), 700, 1500, 2048, 900, 1200, 0])
    shapes = {
        "gpt_decode": dict(decode, H=12, Kv=12, hd=64),
        "gpt_serve_decode": dict(serve_decode, H=12, Kv=12, hd=64),
        "gpt_mixed": dict(mixed, H=12, Kv=12, hd=64),
        "gqa_decode": dict(decode, H=32, Kv=8, hd=128),
        "gqa_mixed": dict(mixed, H=32, Kv=8, hd=128),
    }
    max_err = {}
    cases = {}
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for i, (name, shp) in enumerate(shapes.items()):
            args = ragged_case(torch, **shp, ps=ps, max_len=L_max, dtype=dtype, seed=i)
            got = PA.paged_attention_blocked(*args)
            torch.cuda.synchronize()
            want = PA.paged_attention_blocked_plain(*args)
            torch.cuda.synchronize()
            atol, rtol = TOL[dt_name]
            err, share = real_rows_err(got, want, shp["q_lens"], atol, rtol)
            pad = torch.arange(got.shape[1], device="cuda")[None, :] >= args[3][:, None]
            check(bool((got[pad] == 0).all()), f"{name} {dt_name}: padding rows not zero")
            check(bool(torch.isfinite(got).all()), f"{name} {dt_name}: non-finite output")
            print(f"[kernel] paged_attention {name} {dt_name} q_max={got.shape[1]}"
                  f" S={got.shape[0]} H={shp['H']} Kv={shp['Kv']} hd={shp['hd']}:"
                  f" max_abs_err {err:.3e}, {share:.3f} of the limit {atol:g} + {rtol:g}|want|")
            check(share <= 1.0, f"paged_attention {name} {dt_name} err {err}")
            max_err[dt_name] = max(max_err.get(dt_name, 0.0), err)
            cases[(name, dt_name)] = args

    # ---- 4. serve gpt-paper at full width: the port's main path ----------
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    engine = PagedServeEngine(cfg, params, max_seqs=SERVE["max_seqs"], max_len=L_max,
                              page_size=ps, prefill_chunk="auto",
                              autochunk_budget=SERVE["budget"], device="cuda")
    check(engine.prefill_chunk == chunk, "engine planned another chunk than phase 3")
    engine.submit(Request(rid=-1, prompt=[1] * 16, max_new_tokens=2))   # warm-up
    engine.run()
    engine.finished.clear()
    engine.sched_stats.update(dict.fromkeys(engine.sched_stats, 0))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=SERVE["max_new"]) for i, n in enumerate(lens)]
    before = stats.snapshot()
    torch.cuda.synchronize()
    PA.paged_attention_blocked.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.paged_attention_blocked.launches
    d = stats.delta(before)
    steps = engine.sched_stats["steps"]
    toks = sum(len(r.generated) for r in reqs)
    check(all(r.done and len(r.generated) == SERVE["max_new"] for r in reqs),
          "not every request finished with max_new tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "a generated token lies outside the vocabulary")
    check(d["mixed_steps"] > 0, "no mixed prefill+decode step")
    check(d["pages_allocated"] == d["pages_freed"] > 0,
          f"pages allocated {d['pages_allocated']} != freed {d['pages_freed']}")
    check(launches == cfg.n_layers * steps > 0,
          f"paged_attention launched {launches} times in {steps} steps")
    ttft = [r.ttft_s for r in reqs]
    print(f"[serve] gpt-paper bf16 full width: {len(reqs)} requests (prompts"
          f" {lens[0]}..{lens[-1]}), {toks} tokens in {wall:.3f}s = {toks / wall:.1f} tok/s,"
          f" {steps} steps ({engine.sched_stats['mixed_steps']} mixed), TTFT mean"
          f" {statistics.mean(ttft):.3f}s max {max(ttft):.3f}s")
    print(f"[serve] planned prefill chunk {chunk} at budget {SERVE['budget']}: predicted"
          f" one-block peak {plan.peak_bytes} B of budget {plan.budget_bytes} B"
          f" (unchunked {plan.baseline_peak_bytes} B)")
    print(f"[serve] paged_attention launches {launches} = {cfg.n_layers} layers x {steps}"
          f" steps; pages allocated {d['pages_allocated']} freed {d['pages_freed']}")

    # ---- 4b. where the serving window's device time goes (informational) --
    # the same requests again under torch.profiler; its host overhead
    # stretches this window's wall time, so shares are of the untraced wall
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    again = [Request(rid=100 + r.rid, prompt=r.prompt, max_new_tokens=SERVE["max_new"])
             for r in reqs]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r in again:
            engine.submit(r)
        engine.run()
        torch.cuda.synchronize()
    device_us = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device_us[e.name] += e.time_range.elapsed_us()
    busy = sum(device_us.values()) / 1e6
    if busy == 0:
        print("[trace] torch.profiler recorded no device time: the split of the"
              " serving window is not measured")
    else:
        attn = sum(us for n, us in device_us.items() if "paged_attention_kernel" in n) / 1e6
        print(f"[trace] serving window on the device: busy {busy:.4f}s of the untraced"
              f" {wall:.4f}s wall (idle {1 - busy / wall:.1%}); paged_attention_kernel"
              f" {attn:.4f}s = {attn / wall:.1%} of wall, {attn / busy:.1%} of busy; {card}")
        for n, us in device_us.most_common(8):
            print(f"[trace]   {us / 1e3:10.3f} ms  {n[:100]}")
    del engine, params

    # ---- 5. served logits against the dense forward, fp32 ----------------
    cfg32 = cfg.with_(dtype="float32")
    params32 = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(1),
                             device="cuda")
    engine = PagedServeEngine(cfg32, params32, max_seqs=2, max_len=1024, page_size=ps,
                              prefill_chunk="auto", autochunk_budget=SERVE["budget"],
                              device="cuda")
    captured = []
    run_ragged = engine.run_ragged
    engine.run_ragged = lambda *a: captured.append(run_ragged(*a)) or captured[-1]
    prompt = rng.integers(0, cfg.vocab_size, 600).tolist()
    engine.submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
    engine.run()
    served = captured[-1][0]
    dense = M.forward(cfg32, params32, {"tokens": torch.tensor([prompt], device="cuda")})[0]
    dense = dense[0, -1]
    err = float((served - dense).abs().max())
    check(served.shape == dense.shape == (cfg.vocab_padded,), "logit shapes differ")
    check(bool(torch.isfinite(served[:cfg.vocab_size]).all()), "non-finite served logits")
    print(f"[logits] fp32 prompt of 600 in {len(captured)} chunks of {engine.prefill_chunk}:"
          f" served vs dense forward max_abs_err {err:.3e} (limit 1e-3)")
    check(err <= 1e-3, f"served logits differ from the dense forward by {err}")
    del engine, params32, captured, served, dense

    # ---- 6. estimator on the card (informational) ------------------------
    g = torch.Generator(device="cuda").manual_seed(2)
    block = M.dense_block_params(cfg, g, device="cuda")
    x = torch.randn((1, chunk, cfg.d_model), generator=g, device="cuda").to(cfg.torch_dtype)
    kv = [torch.randn((1, L_max, cfg.n_kv_heads, cfg.hd), generator=g,
                      device="cuda").to(cfg.torch_dtype) for _ in range(2)]
    step = prefill_block_step(cfg, chunk, L_max)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        out = step(block, x, *kv)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    print(f"[estimate] one block step, chunk {chunk} against {L_max}: predicted peak"
          f" {plan.peak_bytes} B, measured max_memory_allocated delta {measured} B"
          f" (ratio {measured / plan.peak_bytes:.3f})")
    del block, x, kv, out

    # ---- 7. times at the serving shapes ----------------------------------
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    timed = {}
    for name in ("gpt_decode", "gpt_serve_decode", "gpt_mixed"):
        shp = shapes[name]
        q, pages, table, q_lens, kv_lens = args = cases[(name, "bfloat16")]
        nbytes, ops = work(shp["q_lens"], shp["kv_lens"], shp["H"], shp["Kv"], shp["hd"],
                           table.shape[1], 2)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
        # the library yardstick: SDPA on the gathered dense KV with the
        # same ragged causal mask
        S, q_max, H, hd = q.shape
        Kv = shp["Kv"]
        L_ctx = max(shp["kv_lens"])
        kd, vd = PA.split_kv(pages[table.long()].reshape(S, -1, 2 * Kv, hd)[:, :L_ctx])
        kd, vd = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
        qd = q.transpose(1, 2).contiguous()
        qpos = (kv_lens - q_lens)[:, None] + torch.arange(q_max, device="cuda")[None]
        kpos = torch.arange(L_ctx, device="cuda")
        mask = ((kpos[None, None] <= qpos[:, :, None])
                & (kpos[None, None] < kv_lens[:, None, None]))[:, None]
        timed[name] = {
            "ms": time_ms(torch, lambda: PA.paged_attention_blocked(*args), flush),
            "plain_ms": time_ms(torch, lambda: PA.paged_attention_blocked_plain(*args), flush),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=True), flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "q_max": q_max, "bytes": nbytes, "operations": ops,
        }
        t = timed[name]
        print(f"[time] paged_attention {name} bf16 (S={S} q_max={q_max} H={H} hd={hd}):"
              f" kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']};"
              f" {nbytes} B, {ops} ops), plain {t['plain_ms']:.4f} ms,"
              f" SDPA {t['library_ms']:.4f} ms, {t['bound_ms'] / t['ms']:.1%} of bound;"
              f" {card}")

    # ---- 8. the compiler path: autochunk on gpt-paper at full width ------
    # compile + drive (counts zeroed just before, read just after), for the
    # computed-mask kernel and then, under mask_mode="bool", the masked one;
    # each followed by the float32 check of chunked against unchunked logits
    from repro_torch.kernels import chunked_attention as CA

    cfg_c = cfg.with_(scan_layers=False)                  # 12 layers, bf16
    fwd = {}
    fp32_err = {}
    for mode in ("auto", "bool"):
        fwd[mode] = run_compiled_forward(torch, CA, stats, M, cfg_c, card, mask_mode=mode)
        fp32_err[mode] = check_forward_fp32(torch, M, cfg_c, mask_mode=mode)
        torch.cuda.empty_cache()

    # ---- 9. the chunked-attention kernels against their plain versions --
    c_chunk, ext = fwd["auto"]["chunk"], COMPILE["seq_len"]
    attn_err = check_attention_kernels(torch, CA, gpt_attention_cases(c_chunk, ext))

    # ---- 10. their times at the compiled forward's chunk shape ----------
    attn_timed = time_attention_kernels(torch, F, CA, c_chunk, ext, flush, card)

    # ---- 11. per-block AutoChunk in minitron-4b's forward ----------------
    # counts zeroed just before the per-block forward and read just after;
    # then the float32 check at 4 layers
    from repro_torch.kernels import chunked_ffn as CF

    torch.cuda.empty_cache()
    block = run_block_forward(torch, CA, CF, stats, M, card, attn_err)
    torch.cuda.empty_cache()
    block.update(check_block_forward_fp32(torch, CF, stats, M))
    torch.cuda.empty_cache()

    # ---- 12. computed_attention's time at the block's last chunk ---------
    ac = block["attention_check"]
    block_attn_timed = time_attention_kernels(
        torch, F, CA, ac["Sq"], ac["Skv"], flush, card, N=ac["N"], group=ac["group"],
        hd=ac["hd"], names=("computed_attention",))["computed_attention"]

    # ---- 13. chunked_ffn against its plain version, then its time --------
    mcfg = get_config(BLOCK["arch"])
    ffn_err = check_ffn_kernel(torch, CF, mcfg, (block["chunk"],) + FFN_ROWS)
    ffn_timed = time_ffn_kernel(torch, F, CF, mcfg, block["chunk"], flush, card)

    # ---- 14. kernels lines and the result --------------------------------
    launch_counts = {"paged_attention": launches,
                     "computed_attention": fwd["auto"]["launches"],
                     "masked_attention": fwd["bool"]["launches"],
                     "chunked_ffn": block["launches"]}
    errs = {"paged_attention": max_err, "chunked_ffn": ffn_err}
    for (kname, dt_name), err in attn_err.items():
        errs.setdefault(kname, {})[dt_name] = err
    print("kernels: " + json.dumps([{"name": k, "launches": n,
                                     "max_err_bf16": errs[k]["bfloat16"],
                                     "max_err_fp32": errs[k]["float32"]}
                                    for k, n in launch_counts.items()]))
    # the top-level times are the serving run's decode step, the shape it
    # launches most; "shapes" carries the longer decode and the mixed step
    entry = {
        "name": "paged_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:204",
        "launches": launches,
        "max_abs_err": max_err["bfloat16"],
        **{k: timed["gpt_serve_decode"][k] for k in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "max_err_bf16": max_err["bfloat16"],
        "max_err_fp32": max_err["float32"],
        "shapes": timed,
    }
    entries = [entry]
    for kname, mode, line in (("computed_attention", "auto", 138),
                              ("masked_attention", "bool", 223)):
        t = attn_timed[kname]
        entries.append({
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chunked_attention.cu",
            "replaces": f"src/repro/kernels/chunked_attention.py:{line}",
            "launches": launch_counts[kname],
            "max_abs_err": errs[kname]["bfloat16"],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "max_err_bf16": errs[kname]["bfloat16"],
            "max_err_fp32": errs[kname]["float32"],
            "shape": {k: t[k] for k in ("sq", "skv", "q_offset", "bytes", "operations")},
            "forward": dict(fwd[mode], fp32_logits_err=fp32_err[mode]),
        })
    entries[1]["block_shape"] = block_attn_timed
    # computed_attention also carries the per-block path: its launches there
    # are in the chunked_ffn entry's "forward" record, its time at that
    # path's chunk in its own "block_shape"
    entries.append({
        "name": "chunked_ffn",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunked_ffn.cu",
        "replaces": "src/repro/kernels/chunked_ffn.py:55",
        "launches": block["launches"],
        "max_abs_err": ffn_err["bfloat16"],
        **{k: ffn_timed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "max_err_bf16": ffn_err["bfloat16"],
        "max_err_fp32": ffn_err["float32"],
        "shape": {k: ffn_timed[k] for k in ("rows", "d", "f", "bytes", "operations")},
        "forward": block,
    })
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
