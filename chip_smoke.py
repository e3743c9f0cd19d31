#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (one compiler per source, in parallel), prints each kernel's
registers, shared memory and spills (``-Xptxas -v``) and, from
``cuobjdump -sass``, the tensor-core instructions of every library
(``[route]`` lines; the bf16 attention kernel, computed and masked, and
the bf16 FFN kernel must have HGMMA, the bf16 SSD kernel HMMA or HGMMA,
their f32 kernels, the mask's tile pre-pass and the RG-LRU kernels none),
and drives the port's paths, two at
gpt-paper's full width, one at minitron-4b's, two at phi3-mini-3.8b's, one
at mamba2-1.3b's and two at recurrentgemma-9b's:

* serving: the paged engine, its kernel held against its plain version at
  the serving shapes (gpt-paper's and phi3-mini's heads) and at edge cases
  (split decode batches with a row of q_len 0 and splits past kv_len, GQA
  hd 256, hd 96), the served tokens' digest beside those served with the
  plain version swapped in, the served logits against the dense forward;
  then phi3-mini-3.8b (hd 96) served the same way at full width, its fp32
  served logits at 4 layers against its dense forward, and a head dim the
  paged kernel has no instance for (48) refused when the engine is built;
* the AutoChunk compiler: the 12-layer bf16 forward of 8192 tokens compiled
  at a 0.2 activation budget, once with the computed-mask attention kernel
  and once with ``mask_mode="bool"`` (the bool-mask kernel); predicted and
  measured activation peaks and times of the chunked and unchunked
  forwards, and chunked against unchunked logits in float32.
  Both attention kernels are then held against their plain versions at the
  compiled chunk shape (plus a window and a GQA case, ragged Sq and Skv,
  hd 32, a window whose first rows see no live key, and at hd 80, 96 and
  256 each a ragged causal case, such a window and recurrentgemma's MQA
  in its 2048-key window); the masked one
  also with a random per-head mask holding a row with no live key, and at
  the GQA cases with per-head masks holding dead tiles and such a row;
* the plan cache: the precompile CLI, run as a subprocess, writes the plan
  of that gpt-paper compile (traced on ``meta``) into a fresh directory; a
  fresh ``autochunk(..., cache=dir)`` of the same forward replays it from
  disk (1 hit, 0 misses, 0 search passes, the cold compile's stages, the
  same ``computed_attention`` launches, logits bit-equal to the cold
  compile's; cold and warm host seconds side by side); then a
  ``canonical_bucket_exec`` function compiled at S 8192 serves S 6000 and
  7000 by padding (2 bucket-executable hits, 0 traces, 0 searches, the
  S 6000 peak within 1.05x of the S 8192 one), and its padded float32
  logits at S 6000 are held within 1e-3 of the unchunked forward's;
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
  the fused and the separate weights;
* phi3-mini-3.8b per block (2 layers, full width, S 8192, budget 0.03):
  its attention (hd 96) on ``computed_attention`` and its SwiGLU MLP on
  ``chunked_ffn``, the chunked block's peak within 5% of its prediction,
  float32 per-block logits within 1e-3 of the unchunked ones;
* the SSM family: mamba2-1.3b's 48-layer bf16 forward of 8192 tokens, each
  block's scan on ``ssd_scan``, unchunked and per block with
  ``autochunk_budget=0.9`` (the scan stays one kernel op in the compiled
  block); the block's predicted and measured activation peaks, and its
  peak with the plain SSD swapped in by this script; the logits in float32
  at 4 layers against those with the plain version swapped in, and the
  bf16 logits bounded against them;
* the hybrid family: recurrentgemma-9b's 38-layer bf16 forward of 8192
  tokens, its 26 RG-LRU layers on ``rglru_scan``, and its float32 logits
  at 3 layers (two RG-LRU, one local attention) against the plain version;
  then the same forward under ``autochunk_budget=0.1``: one plan for the
  attention block (its attention on ``computed_attention`` at hd 256, 16
  query heads over 1) and one for the RG-LRU block (its scan one op node),
  each block's peak within 5% of its prediction, the launches, peaks and
  times beside the unbudgeted forward, float32 per-block logits at 3 layers
  within 1e-3 of the unbudgeted ones and bf16 no further from float32 than
  1.5 times the unbudgeted bf16 logits.
  Both scans are first held against their plain versions (mamba2's shape,
  a length the chunk does not divide, the reduced config's chunk 16, a
  shape off every tile edge (p 48, n 64, chunk 100), and with dt and A
  drawn as Mamba-2 initialises them mamba2's shape, 1000 rows and batch
  2; recurrentgemma's shape, an odd length, batch 2 and a width that is
  no multiple of the kernel's 32-channel tile; f32 and bf16 inputs).

Each path runs with the kernels' launch counts zeroed just before and read
just after.  Every kernel is timed beside its bound, its plain version and
the one PyTorch call that computes the same function; the attention
kernels also at the new head dims' model shapes (phi3-mini's chunk at hd
96, recurrentgemma's at hd 256, a non-causal hd-80 shape), each held
against its plain version at that shape before it is timed.  Any failed phase
exits non-zero.  Without a CUDA device, or run from a directory that lacks
the repository's ``src/``, it exits non-zero and prints no result.

The last two lines of standard output are the kernels' JSON line and
``{"ok": true, "device": {...}}``; the card's name and power limit, as
``nvidia-smi`` reports them, come on the line before those.
"""
from __future__ import annotations

import collections
import hashlib
import concurrent.futures
import json
import math
import re
import shutil
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


def token_digest(reqs) -> str:
    """The first 16 hex digits of a sha256 over every request's generated
    tokens, in request order."""
    return hashlib.sha256(json.dumps([r.generated for r in reqs]).encode()).hexdigest()[:16]


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


def bound(nbytes, ops):
    """The least time the card could take: the larger of ``nbytes`` over the
    memory rate and ``ops`` over the bf16 peak, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops
                else "operations", bytes=nbytes, operations=ops)


def demangle(names):
    """C++ names as ``c++filt`` prints them (unchanged where it is missing)."""
    if not names or not shutil.which("c++filt"):
        return list(names)
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                         timeout=60)
    return out.stdout.splitlines() if out.returncode == 0 else list(names)


def ptxas_report(name, log):
    """Each kernel's registers, shared memory and spills from ``-Xptxas -v``."""
    entries, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        elif fn and ("spill stores" in line or "registers" in line):
            entries.append((fn, line.split(":", 1)[-1].strip()))
    names = dict(zip(sorted({f for f, _ in entries}), demangle(sorted({f for f, _ in entries}))))
    for fn, what in entries:
        print(f"[build] {name}: {names[fn][:90]}: {what}")


def tool(name):
    """A CUDA toolkit binary: on PATH or under /usr/local/cuda/bin."""
    found = shutil.which(name) or (f"/usr/local/cuda/bin/{name}"
                                   if Path(f"/usr/local/cuda/bin/{name}").exists() else None)
    check(found, f"{name} not found")
    return found


def tensor_core_counts(lib):
    """{kernel name: Counter of its tensor-core instructions (HGMMA, the
    warpgroup wgmma; HMMA, the warp-level mma.sync) by SASS opcode}, from
    ``cuobjdump -sass`` of a built library."""
    out = subprocess.run([tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib}: {out.stderr.strip()[:200]}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        op = re.search(r"\b(HGMMA|HMMA)\.[\w.]+", line)
        if fn and op:
            counts[fn][op.group(0)] += 1
    return dict(zip(demangle(list(counts)), counts.values()))


def route_report(build, name, wanted):
    """Print the tensor-core instruction count of every kernel in library
    ``name``.  A kernel whose name holds a key of ``wanted`` must have HGMMA
    (wgmma) instructions where ``wanted`` says True, tensor-core
    instructions of either kind (HGMMA or the warp-level HMMA) where it
    says "tensor cores", and none at all where it says False.  Returns
    {kernel: count}."""
    counts = tensor_core_counts(build.library_path(name))
    total = {}
    for fn, c in sorted(counts.items()):
        total[fn] = sum(c.values())
        hgmma = sum(n for op, n in c.items() if op.startswith("HGMMA"))
        print(f"[route] {name}: {fn[:90]}: {total[fn]} tensor-core instructions"
              f" {dict(c) or ''}")
        for key, need in wanted.items():
            if key in fn:
                ok = (total[fn] > 0 if need == "tensor cores" else hgmma > 0 if need
                      else total[fn] == 0)
                check(ok, f"{fn}: {hgmma} HGMMA of {total[fn]} tensor-core instructions,"
                          f" want {need}")
    return total


# ---------------------------------------------------------------------------
# The paged kernel at the serving shapes and its edge cases
# ---------------------------------------------------------------------------

# decode batches with a kv_len that is no multiple of the split, a row with
# q_len 0 and splits wholly past kv_len, at gpt-paper's heads and at GQA
# hd 256; and a mixed batch at GQA hd 256 (its decode rows split, its
# prefill row's later query tiles not)
PAGED_EDGE_SHAPES = {
    "edge_split_hd64": dict(q_lens=[1, 0, 1, 1], kv_lens=[513, 0, 2048, 5], H=12, Kv=12, hd=64),
    "edge_split_gqa_hd256": dict(q_lens=[1, 1, 0, 1], kv_lens=[300, 1, 0, 777], H=16, Kv=2,
                                 hd=256),
    "edge_mixed_gqa_hd256": dict(q_lens=[3, 1, 0, 9], kv_lens=[40, 300, 0, 1200], H=16, Kv=2,
                                 hd=256),
    # hd 96 (phi3-mini): lane groups of 16 (bf16) or 32 (f32) lanes with 12
    # or 24 loading; a split decode batch at phi3's heads, a mixed batch at
    # phi3's heads and one under GQA (8 query vectors a block)
    "edge_split_hd96": dict(q_lens=[1, 0, 1, 1], kv_lens=[513, 0, 2048, 5], H=32, Kv=32, hd=96),
    "edge_mixed_hd96": dict(q_lens=[3, 1, 0, 9], kv_lens=[40, 300, 0, 1200], H=32, Kv=32,
                            hd=96),
    "edge_mixed_gqa_hd96": dict(q_lens=[3, 1, 0, 9], kv_lens=[40, 300, 0, 1200], H=16, Kv=4,
                                hd=96),
}


def check_paged_kernel(torch, PA, shapes, ps, max_len):
    """The kernel against its plain version on every shape, fp32 and bf16;
    padding rows must be zeros.  Returns (max error by dtype, the inputs by
    (shape, dtype))."""
    max_err, cases = {}, {}
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for i, (name, shp) in enumerate(shapes.items()):
            args = ragged_case(torch, **shp, ps=ps, max_len=max_len, dtype=dtype, seed=i)
            got = PA.paged_attention_blocked(*args)
            torch.cuda.synchronize()
            want = PA.paged_attention_blocked_plain(*args)
            torch.cuda.synchronize()
            atol, rtol = TOL[dt_name]
            err, share = real_rows_err(got, want, shp["q_lens"], atol, rtol)
            pad = torch.arange(got.shape[1], device="cuda")[None, :] >= args[3][:, None]
            check(bool((got[pad] == 0).all()), f"{name} {dt_name}: padding rows not zero")
            check(bool(torch.isfinite(got).all()), f"{name} {dt_name}: non-finite output")
            n_split, split_keys = PA.split_plan(ps, args[2].shape[1])
            print(f"[kernel] paged_attention {name} {dt_name} q_max={got.shape[1]}"
                  f" S={got.shape[0]} H={shp['H']} Kv={shp['Kv']} hd={shp['hd']}"
                  f" kv_lens={shp['kv_lens']} splits {n_split} x {split_keys}:"
                  f" max_abs_err {err:.3e}, {share:.3f} of the limit {atol:g} + {rtol:g}|want|")
            check(share <= 1.0, f"paged_attention {name} {dt_name} err {err}")
            max_err[dt_name] = max(max_err.get(dt_name, 0.0), err)
            cases[(name, dt_name)] = args
    return max_err, cases


def time_paged_kernel(torch, F, PA, shapes, cases, flush, card):
    """The kernel at the given serving shapes in bf16, beside its bound, its
    plain version and SDPA on the gathered dense KV with the same ragged
    causal mask."""
    timed = {}
    for name, shp in shapes.items():
        q, pages, table, q_lens, kv_lens = args = cases[(name, "bfloat16")]
        nbytes, ops = work(shp["q_lens"], shp["kv_lens"], shp["H"], shp["Kv"], shp["hd"],
                           table.shape[1], 2)
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
            **bound(nbytes, ops),
            "q_max": q_max,
        }
        t = timed[name]
        print(f"[time] paged_attention {name} bf16 (S={S} q_max={q_max} H={H} hd={hd}):"
              f" kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']};"
              f" {nbytes} B, {ops} ops), plain {t['plain_ms']:.4f} ms,"
              f" SDPA {t['library_ms']:.4f} ms, {t['bound_ms'] / t['ms']:.1%} of bound;"
              f" {card}")
    return timed


def serve_timed(torch, PA, stats, engine, cfg, reqs, label=""):
    """Serve ``reqs`` on ``engine`` with the paged kernel's launch count
    zeroed just before and read just after; every request must finish with
    its new tokens, in the vocabulary, through at least one mixed step, with
    every page freed and one launch a layer a step.  Returns (wall seconds,
    launches, stats delta, steps, tokens)."""
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
          f"{label}not every request finished with max_new tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"{label}a generated token lies outside the vocabulary")
    check(d["mixed_steps"] > 0, f"{label}no mixed prefill+decode step")
    check(d["pages_allocated"] == d["pages_freed"] > 0,
          f"{label}pages allocated {d['pages_allocated']} != freed {d['pages_freed']}")
    check(launches == cfg.n_layers * steps > 0,
          f"{label}paged_attention launched {launches} times in {steps} steps")
    return wall, launches, d, steps, toks


def serve_plain_swapped(PA, engine, reqs):
    """The same requests again with the plain version put where the engine
    calls the kernel (this script's comparison; the engine has no switch).
    Returns the requests and how many of their tokens equal the kernel's."""
    from repro_torch.serving import Request
    from repro_torch.serving import engine as serving_engine

    plain_reqs = [Request(rid=200 + r.rid, prompt=r.prompt, max_new_tokens=SERVE["max_new"])
                  for r in reqs]
    serving_engine.paged_attention_blocked = PA.paged_attention_blocked_plain
    try:
        for r in plain_reqs:
            engine.submit(r)
        engine.run()
    finally:
        serving_engine.paged_attention_blocked = PA.paged_attention_blocked
    same = sum(a == b for r, rp in zip(reqs, plain_reqs) for a, b in zip(r.generated, rp.generated))
    return plain_reqs, same


def serve_phi3(torch, PA, stats, M, lens, card):
    """phi3-mini-3.8b served at full width (32 layers, bf16) by the paged
    engine on the card, its hd 96 on the paged kernel: the serving run's
    requests again, the launch count zeroed just before and read just
    after, then the same requests with the plain version swapped in (which
    served tokens the kernel's rounding changed, for information).  A head
    dim without a paged instance (48) is still refused at construction."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serving import PagedServeEngine, Request

    cfg = get_config("phi3-mini-3.8b")
    check(PA.cuda_refusal(cfg.hd) is None, f"no paged kernel instance at hd {cfg.hd}")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(3), device="cuda")
    engine = PagedServeEngine(cfg, params, max_seqs=SERVE["max_seqs"], max_len=SERVE["max_len"],
                              page_size=SERVE["page_size"], prefill_chunk="auto",
                              autochunk_budget=SERVE["budget"], device="cuda")
    engine.submit(Request(rid=-1, prompt=[1] * 16, max_new_tokens=2))   # warm-up
    engine.run()
    engine.finished.clear()
    engine.sched_stats.update(dict.fromkeys(engine.sched_stats, 0))
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=SERVE["max_new"]) for i, n in enumerate(lens)]
    wall, launches, d, steps, toks = serve_timed(torch, PA, stats, engine, cfg, reqs, "phi3: ")
    ttft = [r.ttft_s for r in reqs]
    plan = engine.prefill_plan
    print(f"[serve] phi3-mini-3.8b bf16 full width (L={cfg.n_layers} d={cfg.d_model}"
          f" H={cfg.n_heads} hd={cfg.hd}): {len(reqs)} requests (prompts {lens[0]}..{lens[-1]}),"
          f" {toks} tokens in {wall:.3f}s = {toks / wall:.1f} tok/s, {steps} steps"
          f" ({engine.sched_stats['mixed_steps']} mixed), TTFT mean {statistics.mean(ttft):.3f}s"
          f" max {max(ttft):.3f}s; {card}")
    print(f"[serve] phi3-mini-3.8b planned prefill chunk {engine.prefill_chunk} at budget"
          f" {SERVE['budget']}: predicted one-block peak {plan.peak_bytes} B of budget"
          f" {plan.budget_bytes} B (unchunked {plan.baseline_peak_bytes} B)")
    print(f"[serve] phi3-mini-3.8b paged_attention launches {launches} = {cfg.n_layers} layers x"
          f" {steps} steps; pages allocated {d['pages_allocated']} freed {d['pages_freed']};"
          f" served tokens sha256 {token_digest(reqs)}")
    plain_reqs, same = serve_plain_swapped(PA, engine, reqs)
    print(f"[serve] phi3-mini-3.8b with the plain version swapped in: served tokens sha256"
          f" {token_digest(plain_reqs)}; {same} of {toks} tokens equal to the kernel's")
    del engine, params
    torch.cuda.empty_cache()

    # a head dim the paged kernel has no instance for: refused at
    # construction, before anything is allocated, not at the first step
    hcfg = cfg.with_(n_heads=64, n_kv_heads=64)
    check(hcfg.hd == 48 and PA.cuda_refusal(48) is not None, "hd 48 has a paged instance")
    try:
        PagedServeEngine(hcfg, None, max_seqs=2, max_len=1024, page_size=SERVE["page_size"],
                         device="cuda")
    except NotImplementedError as e:
        print(f"[serve] hd {hcfg.hd} on the card: the engine refuses at construction: {e}")
    else:
        fail("PagedServeEngine was built for hd 48 on the card")
    return dict(launches=launches, steps=steps, tokens=toks, wall_s=wall, tok_s=toks / wall,
                ttft_mean_s=statistics.mean(ttft), ttft_max_s=max(ttft),
                prefill_chunk=plan.chunk, plain_tokens_equal=same)


def check_served_logits(torch, M, cfg32, seed, prompt, label=""):
    """The fp32 engine's logits of the last prompt token (the prompt
    prefilled in chunks) against the dense forward, within 1e-3."""
    from repro_torch.serving import PagedServeEngine, Request

    params32 = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(seed),
                             device="cuda")
    engine = PagedServeEngine(cfg32, params32, max_seqs=2, max_len=1024,
                              page_size=SERVE["page_size"], prefill_chunk="auto",
                              autochunk_budget=SERVE["budget"], device="cuda")
    captured = []
    run_ragged = engine.run_ragged
    engine.run_ragged = lambda *a: captured.append(run_ragged(*a)) or captured[-1]
    engine.submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
    engine.run()
    served = captured[-1][0]
    dense = M.forward(cfg32, params32, {"tokens": torch.tensor([prompt], device="cuda")})[0]
    dense = dense[0, -1]
    err = float((served - dense).abs().max())
    check(served.shape == dense.shape == (cfg32.vocab_padded,), "logit shapes differ")
    check(bool(torch.isfinite(served[:cfg32.vocab_size]).all()), "non-finite served logits")
    print(f"[logits] {label}fp32 prompt of {len(prompt)} in {len(captured)} chunks of"
          f" {engine.prefill_chunk}: served vs dense forward max_abs_err {err:.3e} (limit 1e-3)")
    check(err <= 1e-3, f"{label}served logits differ from the dense forward by {err}")
    del engine, params32, captured, served, dense
    torch.cuda.empty_cache()
    return err


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


# ragged Sq and Skv (GQA), hd 32, and a causal window whose first rows sit
# before key 0 and see no live key (they average V over the visited tiles)
ATTENTION_EDGE_CASES = [
    dict(name="ragged_1000x8000", N=4, group=2, hd=64, Sq=1000, Skv=8000, off=7000, window=None),
    dict(name="ragged_17x100", N=2, group=3, hd=128, Sq=17, Skv=100, off=83, window=None),
    dict(name="hd32", N=4, group=1, hd=32, Sq=300, Skv=700, off=400, window=None),
    dict(name="window_dead_rows", N=4, group=1, hd=64, Sq=200, Skv=512, off=-40, window=128),
]
# the head dims of hubert-xlarge (80), phi3-mini (96) and recurrentgemma's
# local attention (256), each causal with ragged Sq and Skv and a q_offset
# short of the last key, in a window whose first rows see no key, and as
# recurrentgemma's MQA (16 query heads over 1 kv head) in its 2048-key
# window cut by the band
ATTENTION_HD_CASES = [
    c for hd in (80, 96, 256) for c in (
        dict(name=f"hd{hd}_ragged", N=3, group=2, hd=hd, Sq=333, Skv=1500, off=1100,
             window=None),
        dict(name=f"hd{hd}_window_dead_rows", N=4, group=1, hd=hd, Sq=200, Skv=512, off=-40,
             window=128),
        dict(name=f"hd{hd}_mqa_window", N=1, group=16, hd=hd, Sq=700, Skv=3000, off=2300,
             window=2048))
]


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
            if c["group"] > 1:
                # per head: the band, or on every other head the band cut to
                # blocks of 512 keys (dead tiles beside partial ones), and
                # a row with no live key at all (its query tile walks every
                # kv tile and the row gets the mean of all V)
                m = band[None].repeat(c["N"] * c["group"], 1, 1)
                m[1::2] &= kpos // 512 == qpos // 512
                m[:, min(5, chunk - 1)] = False
                masks.append(("per_head", m))
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
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    return compare(torch, kname, label, got, want, tol)


def compare(torch, kname, label, got, want, tol, why=""):
    """``got`` against ``want`` elementwise within ``atol + rtol |want|``;
    prints (with ``why``, the limit's reason) and returns the max abs error."""
    atol, rtol = tol
    d = (got.float() - want.float()).abs()
    err = float(d.max())
    share = float((d / (atol + rtol * want.float().abs())).max())
    check(bool(torch.isfinite(got).all()), f"{kname} {label}: non-finite")
    print(f"[kernel] {kname} {label}: max_abs_err {err:.3e}, {share:.3f} of the limit"
          f" {atol:g} + {rtol:g}|want|{why}")
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


def run_compiled_forward(torch, CA, stats, M, cfg, card, *, mask_mode, keep=None):
    """The port's compiler path at full width: compile, drive it with the
    kernel counts zeroed just before and read just after, check it.  With
    ``keep`` (a dict), the cold compile, its model, batch and host seconds
    stay there for the ``[cache]`` phase."""
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
        trace = device_time_split(torch, lambda: compiled(params, batch), card,
                                  f"compiled gpt-paper forward ({mask_mode})",
                                  {kname: ("chunk_attention",),
                                   "cuBLAS products": ("gemm", "nvjet")})
    check(launches == expected, f"{kname} launched {launches} times, want {expected}")
    check(launches == cfg.n_layers * (expected // cfg.n_layers), "uneven chunk counts")
    check(bool(torch.isfinite(y1[..., :cfg.vocab_size]).all()), "non-finite chunked logits")
    print(f"[forward] {mask_mode}: activation peak unchunked {peak0} B (predicted"
          f" {r.baseline_peak} B), chunked {peak1} B (predicted {r.final_peak} B,"
          f" budget {r.budget_bytes} B): measured reduction {1 - peak1 / peak0:.1%};"
          f" time unchunked {ms0:.2f} ms, chunked {ms1:.2f} ms; {kname} launches"
          f" {launches} = {cfg.n_layers} layers x {expected // cfg.n_layers} chunks; {card}")
    out = dict(launches=launches, chunk=chunks[0], peak0=peak0, peak1=peak1, ms0=ms0, ms1=ms1,
               pred0=r.baseline_peak, pred1=r.final_peak, device_ms=trace)
    if keep is not None:
        keep.update(compiled=compiled, planned=planned, model=model, batch=batch,
                    seconds=(t_trace, t_search, t_compile), launches=launches, peak1=peak1)
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


# ---------------------------------------------------------------------------
# The plan cache: precompiled gpt-paper replayed from disk, and a canonical
# bucket executable serving shorter lengths of its bucket
# ---------------------------------------------------------------------------

CACHE = dict(bucket_lens=(6000, 7000), precompile_timeout=900)


def stage_shapes(stages):
    """Regions, chunk counts and chunk extents of a plan's stages."""
    return [((st.s, st.e), st.n_chunks, st.chunk_extent) for st in stages]


def precompile_plans(cache_dir):
    """``python -m repro_torch.tools.precompile`` for the ``[compile]`` cell,
    as a subprocess; returns (plans on disk, host seconds)."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.tools.precompile", "--configs", "gpt-paper",
           "--full", "--seq-lens", str(COMPILE["seq_len"]), "--budgets", str(COMPILE["budget"]),
           "--max-stages", str(COMPILE["max_stages"]), "--cache-dir", str(cache_dir)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=CACHE["precompile_timeout"])
    seconds = time.perf_counter() - t0
    for line in (proc.stdout + proc.stderr).splitlines():
        print(f"[cache] precompile: {line}")
    check(proc.returncode == 0, f"precompile exited {proc.returncode}")
    return len(list(Path(cache_dir).glob("*.json"))), seconds


def run_cache_phase(torch, CA, stats, M, cfg, cold, card):
    """Warm replay of the precompiled full-width plan from disk against the
    ``[compile]`` phase's cold compile (kept in ``cold``), then the canonical
    bucket executable at S 8192, 6000 and 7000.  Kernel counts zeroed just
    before each drive and read just after."""
    import tempfile

    import numpy as np
    from repro_torch.core import ChunkConfig, autochunk

    S = COMPILE["seq_len"]
    knobs = dict(budget_ratio=COMPILE["budget"], max_stages=COMPILE["max_stages"])
    model, batch = cold["model"], cold["batch"]
    params = dict(model.named_parameters())
    with tempfile.TemporaryDirectory(prefix="plans-") as cache_dir:
        n_plans, pre_s = precompile_plans(cache_dir)
        check(n_plans == 1, f"{n_plans} plans precompiled, want 1")
        print(f"[cache] precompile gpt-paper S={S} budget {COMPILE['budget']} on meta:"
              f" {n_plans} plan in {pre_s:.2f} host seconds (a subprocess, its start-up"
              " included)")

        # ---- warm replay from disk --------------------------------------
        cf = autochunk(M.logits_fn(model), ChunkConfig(**knobs), cache=cache_dir)
        before = stats.snapshot()
        t0 = time.perf_counter()
        warm = cf.compile(params, batch)
        warm_s = time.perf_counter() - t0
        d = stats.delta(before)
        cold_s = sum(cold["seconds"])
        cold_stages = stage_shapes(cold["planned"].plan.stages)
        warm_stages = stage_shapes(warm.result.plan_stages)
        print(f"[cache] warm compile from disk: plan_cache_hits {d['plan_cache_hits']},"
              f" misses {d['plan_cache_misses']}, search passes {d['search_passes']},"
              f" traces {d['trace_calls']}; {len(warm_stages)} stages"
              f" {'equal to' if warm_stages == cold_stages else 'NOT equal to'} the cold"
              f" compile's; host seconds cold {cold_s:.2f} (trace {cold['seconds'][0]:.2f},"
              f" search {cold['seconds'][1]:.2f}, compile {cold['seconds'][2]:.2f}), warm"
              f" {warm_s:.2f}")
        check(d["plan_cache_hits"] == 1 and d["plan_cache_misses"] == 0,
              f"warm compile: {d['plan_cache_hits']} hits, {d['plan_cache_misses']} misses")
        check(d["search_passes"] == 0, f"warm compile ran {d['search_passes']} search passes")
        check(warm.from_cache, "warm compile not from the cache")
        check(warm_stages == cold_stages, f"warm stages {warm_stages} != cold {cold_stages}")
        with torch.no_grad():
            y_cold = cold["compiled"](params, batch)
            warm(params, batch)                                 # warm-up
            CA.computed_attention.launches = CA.masked_attention.launches = 0
            y_warm, peak_warm, ms_warm = measure_forward(torch, warm, (params, batch))
            launches = CA.computed_attention.launches
        same = torch.equal(y_warm, y_cold)
        diff = float((y_warm.float() - y_cold.float()).abs().max())
        print(f"[cache] warm forward: computed_attention launches {launches} (cold"
              f" {cold['launches']}), activation peak {peak_warm} B (cold {cold['peak1']} B),"
              f" {ms_warm:.2f} ms; logits {'bit-equal to' if same else 'DIFFER from'} the"
              f" cold compile's (max abs diff {diff:.3e}); {card}")
        check(launches == cold["launches"],
              f"warm forward launched computed_attention {launches} times")
        check(same, f"warm logits differ from the cold compile's by {diff}: same plan,"
              " same kernels, so they must be bit-equal")
        del y_cold, y_warm, warm, cf

        # ---- canonical bucket executable --------------------------------
        cfb = autochunk(M.logits_fn(model), ChunkConfig(canonical_bucket_exec=True, **knobs),
                        cache=cache_dir)
        tokens = batch["tokens"]
        with torch.no_grad():
            t0 = time.perf_counter()
            y = cfb(params, batch)             # the bucket's one compile, at S
            torch.cuda.synchronize()
            bucket_s = time.perf_counter() - t0
            del y
            CA.computed_attention.launches = 0
            y, peak_full, ms_full = measure_forward(torch, cfb, (params, batch))
            launches_full = CA.computed_attention.launches
            del y
            before = stats.snapshot()
            rows = []
            for n in CACHE["bucket_lens"]:
                CA.computed_attention.launches = 0
                y, peak, ms = measure_forward(torch, cfb, (params, {"tokens": tokens[:, :n]}))
                check(tuple(y.shape) == (1, n, cfg.vocab_padded), f"S={n}: shape {y.shape}")
                check(bool(torch.isfinite(y[..., :cfg.vocab_size]).all()), f"S={n}: non-finite")
                rows.append((n, peak, ms, CA.computed_attention.launches))
                del y
            d = stats.delta(before)
            # each length again, through its memoized pad / slice wrapper
            again = [measure_forward(torch, cfb, (params, {"tokens": tokens[:, :n]}))[2]
                     for n in CACHE["bucket_lens"]]
        print(f"[cache] bucket executable (canonical_bucket_exec): compiled at S={S} from"
              f" the cache in {bucket_s:.2f} host seconds (its first call included); at S={S}"
              f" peak {peak_full} B, {ms_full:.2f} ms, computed_attention launches"
              f" {launches_full}; then " + "; ".join(
                  f"S={n} padded to {S}: peak {p} B ({p / peak_full:.3f}x), first call"
                  f" {ms:.2f} ms (its meta shape pass included), again {t:.2f} ms, launches {k}"
                  for (n, p, ms, k), t in zip(rows, again))
              + f"; over the first calls bucket_exec_hits {d['bucket_exec_hits']}, traces"
              f" {d['trace_calls']}, search passes {d['search_passes']}")
        check(d["bucket_exec_hits"] == len(rows), f"bucket_exec_hits {d['bucket_exec_hits']}")
        check(d["trace_calls"] == 0 and d["search_passes"] == 0,
              f"warm bucket: {d['trace_calls']} traces, {d['search_passes']} searches")
        check(rows[0][1] <= 1.05 * peak_full,
              f"S={rows[0][0]} peak {rows[0][1]} B above 1.05x the S={S} peak {peak_full} B")
        del cfb

    # ---- the padded fp32 logits against the unchunked forward -----------
    cfg32 = cfg.with_(dtype="float32")
    model32 = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(4), device="cuda")
    params32 = dict(model32.named_parameters())
    n = CACHE["bucket_lens"][0]
    tok = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (1, n)),
                       device="cuda")
    cf32 = autochunk(M.logits_fn(model32), ChunkConfig(canonical_bucket_exec=True, **knobs))
    with torch.no_grad():
        y1 = cf32(params32, {"tokens": tok})
        y0 = M.logits_fn(model32)(params32, {"tokens": tok})
    err = float((y1[..., :cfg.vocab_size] - y0[..., :cfg.vocab_size]).abs().max())
    bucket = cf32.stats()
    print(f"[cache] fp32 S={n} through the bucket executable compiled at S={S}"
          f" ({bucket['bucket_exec_compiles']} compile, {bucket['padded_shapes']} padded"
          f" shape): logits against the unchunked forward at S={n} max_abs_err {err:.3e}"
          " (limit 1e-3)")
    check(bucket["bucket_exec_compiles"] == 1 and bucket["padded_shapes"] == 1,
          f"fp32 bucket executable: {bucket}")
    check(err <= 1e-3, f"padded fp32 logits differ from the unchunked forward by {err}")
    return dict(warm_launches=launches, precompile_s=pre_s, cold_compile_s=cold_s,
                warm_compile_s=warm_s, warm_peak=peak_warm, warm_ms=ms_warm,
                bucket_peak=peak_full, bucket_ms=ms_full,
                bucket_rows=[dict(seq=n, peak=p, first_ms=ms, again_ms=t, launches=k)
                             for (n, p, ms, k), t in zip(rows, again)],
                padded_fp32_err=err)


def time_attention_kernels(torch, F, CA, chunk, ext, flush, card, errs, *, N=12, group=1,
                           hd=64, window=None, causal=True,
                           names=("computed_attention", "masked_attention")):
    """Each kernel at one chunk shape (by default the compiled gpt-paper
    forward's: gpt-paper heads, the last chunk, which sees every key) in
    bf16, first held against its plain version under ``TOL`` (the max error
    merged into ``errs``), then timed beside its bound, its plain version
    and SDPA with the same mask (causal unless ``causal`` is false, within
    ``window`` keys if given)."""
    H, off = N * group, ext - chunk
    q, k, v = attention_case(torch, N=N, group=group, Sq=chunk, Skv=ext, hd=hd,
                             dtype=torch.bfloat16, seed=7)
    scale = hd ** -0.5
    qpos = off + torch.arange(chunk, device="cuda")[:, None]
    kpos = torch.arange(ext, device="cuda")[None, :]
    mask = kpos <= qpos if causal else torch.ones((chunk, ext), dtype=torch.bool,
                                                  device="cuda")
    if window:
        mask = mask & (qpos - kpos < window)
    q4, k4, v4 = q[None], k[None], v[None]
    io = 2 * (2 * H * chunk * hd + 2 * N * ext * hd)      # q, out, K, V in bf16
    pairs = H * band_pairs(chunk, ext, off, causal, window)
    runs = {
        "computed_attention": (
            pairs, io,
            lambda: CA.computed_attention(q, k, v, off, scale=scale, causal=causal,
                                          window=window, group=group),
            lambda: CA.computed_attention_plain(q, k, v, off, scale=scale, causal=causal,
                                                window=window, group=group)),
        # the band's live pairs: the kernel skips the dead tiles
        "masked_attention": (
            pairs, io + chunk * ext,
            lambda: CA.masked_attention(q, k, v, mask[None], scale=scale, group=group),
            lambda: CA.masked_attention_plain(q, k, v, mask[None], scale=scale, group=group)),
    }
    timed = {}
    for name in names:
        pairs, nbytes, kernel, plain = runs[name]
        ops = 4 * pairs * hd
        err = hold(torch, name, f"bf16 Sq={chunk} Skv={ext} H={H} Kv={N} hd={hd}"
                   f" q_offset={off}{f' window={window}' if window else ''}"
                   f"{'' if causal else ' not causal'}", kernel, plain, TOL["bfloat16"])
        errs[(name, "bfloat16")] = max(errs.get((name, "bfloat16"), 0.0), err)
        t = timed[name] = {
            "max_abs_err": err,
            "ms": time_ms(torch, kernel, flush),
            "plain_ms": time_ms(torch, plain, flush),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=scale, enable_gqa=group > 1), flush),
            **bound(nbytes, ops),
            "sq": chunk, "skv": ext, "q_offset": off, "heads": H, "kv_heads": N, "hd": hd,
            "window": window, "causal": causal,
        }
        print(f"[time] {name} bf16 (H={H} Kv={N} Sq={chunk} Skv={ext} hd={hd}"
              f" q_offset={off}{f' window={window}' if window else ''}"
              f"{'' if causal else ' not causal'}): kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms"
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
    trace = device_time_split(torch, per_block, card, "per-block forward", BLOCK_KERNELS)
    del model, p0, h0
    M._AC_CACHE.clear()
    return dict(launches=n_ffn, attention_launches=n_attn, chunk=loops["swiglu"][0],
                attention_chunk=loops["attention"][0], attention_check=attn_check,
                bf16_logits_err=bf16_err, stages=len(r.plan),
                pred_block0=r.baseline_peak, pred_block1=r.final_peak, block_peak0=bpeak0,
                block_peak1=bpeak1, peak0=peak0, peak1=peak1, ms0=ms0, ms1=ms1,
                trace_s=r.trace_s, search_s=r.search_s, device_ms=trace)


# kernel-name patterns of the device time split: the per-block path's
# kernels and the cuBLAS products
BLOCK_KERNELS = {"chunked_ffn": ("ffn_", "cast_bf16", "Memset"),
                 "chunked_ffn's own kernel": ("ffn_",), "its workspace memset": ("Memset",),
                 "its cast": ("cast_bf16",), "computed_attention": ("chunk_attention",),
                 "cuBLAS products": ("gemm", "nvjet")}


def device_time_split(torch, fn, card, label, groups):
    """Device time of one call by kernel name under ``torch.profiler``
    (informational; the profiler's host overhead stretches the wall time):
    busy time and the time of each group of kernel-name patterns."""
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
        print(f"[trace] torch.profiler recorded no device time: the {label}'s split is"
              " not measured")
        return {}
    split = {"busy": busy}
    for key, pats in groups.items():
        split[key] = sum(us for n, us in device_us.items()
                         if any(p in n for p in pats)) / 1e3
    parts = ", ".join(f"{k} {v:.2f} ms ({v / busy:.1%})" for k, v in split.items() if k != "busy")
    print(f"[trace] {label} on the device: busy {busy:.2f} ms; {parts}; {card}")
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
    t = {
        "ms": time_ms(torch, lambda: CF.chunked_ffn_fused(x, w_in, wd), flush),
        "plain_ms": time_ms(torch, lambda: CF.chunked_ffn_plain(x, wg, wu, wd), flush),
        "library_ms": time_ms(torch, lambda: (F.silu(x @ wg) * (x @ wu)) @ wd, flush),
        **bound(nbytes, ops),
        "rows": c, "d": d, "f": f,
    }
    print(f"[time] chunked_ffn bf16 (c={c} d={d} f={f}, fused w_in): kernel {t['ms']:.4f} ms,"
          f" bound {t['bound_ms']:.4f} ms ({t['bound_by']}; {nbytes} B, {ops} ops), plain"
          f" {t['plain_ms']:.4f} ms, cuBLAS chain {t['library_ms']:.4f} ms,"
          f" {t['bound_ms'] / t['ms']:.1%} of bound; {card}")
    return t


# phi3-mini-3.8b per block: its hd 96 has no attention kernel instance, so
# the attention loop stays generic (a dispatch miss) while the SwiGLU MLP
# runs on chunked_ffn
PHI3 = dict(arch="phi3-mini-3.8b", seq_len=8192, layers=2,
            # the loosest round ratio whose block plan chunks the MLP
            budget=0.03)


def run_phi3_forward(torch, CA, CF, stats, M, card):
    """phi3-mini-3.8b's per-block forward at full width, 2 layers, S 8192,
    in bf16 and then float32: one block compiled at the first layer, its
    attention (hd 96) on ``computed_attention`` and its SwiGLU MLP on
    ``chunked_ffn`` (counts zeroed just before the forward and read just
    after); the chunked block's measured peak on layer 0 within 5% of its
    prediction; float32 per-block logits within 1e-3 of unchunked."""
    from repro_torch.configs import get_config

    cfg = get_config(PHI3["arch"]).with_(n_layers=PHI3["layers"])
    L, S = cfg.n_layers, PHI3["seq_len"]
    out = {}
    for dt_name in ("bfloat16", "float32"):
        c = cfg.with_(dtype=dt_name)
        c_ac = c.with_(autochunk_budget=PHI3["budget"])
        model = M.init_params(c, torch.Generator(device="cuda").manual_seed(12), device="cuda")
        batch = block_batch(torch, c, 12)
        M._AC_CACHE.clear()
        with torch.no_grad():
            y0 = M.forward(c, model, batch)[0]
            torch.cuda.synchronize()
            before = stats.snapshot()
            CA.computed_attention.launches = CA.masked_attention.launches = 0
            CF.chunked_ffn.launches = 0
            t0 = time.perf_counter()
            y1 = M.forward(c_ac, model, batch)[0]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        d = stats.delta(before)
        n_ffn, n_attn = CF.chunked_ffn.launches, CA.computed_attention.launches
        n_masked = CA.masked_attention.launches
        (cf,) = M._AC_CACHE.values()
        r = cf.autochunk_result
        p0 = M._index_tree(model["blocks"], 0)
        h0 = M.embed_inputs(c, model, batch)[0]
        loops = block_loops(cf.trace(p0, h0).search())
        err = max_logit_err(y1, y0, c.vocab_size)
        check(bool(torch.isfinite(y1[..., :c.vocab_size]).all()),
              f"phi3 {dt_name}: non-finite per-block logits")
        del y0, y1
        _, _, ms1 = measure_forward(torch, lambda: M.forward(c_ac, model, batch)[0], ())

        def block(p, x):
            return M.dense_block_full(c, p, x, window=None, causal=True)

        with torch.no_grad():
            block(p0, h0)
            _, bpeak0, _ = measure_forward(torch, block, (p0, h0))
            _, bpeak1, _ = measure_forward(torch, cf, (p0, h0))
        attn, swiglu = loops.get("attention", (0, 0)), loops.get("swiglu", (0, 0))
        print(f"[forward] phi3-mini-3.8b per-block {dt_name} L={L} S={S} budget"
              f" {PHI3['budget']}: {secs:.2f}s with the block compile, {ms1:.2f} ms replayed;"
              f" {len(r.plan)} stages; dispatch hits {d['kernel_dispatch_hits']}, misses"
              f" {d['kernel_dispatch_misses']}; computed_attention launches {n_attn} = {L} layers"
              f" x {attn[1]} chunks of {attn[0]} rows (hd {c.hd}), chunked_ffn launches {n_ffn} ="
              f" {L} layers x {swiglu[1]} chunks of {swiglu[0]} rows; layer 0 activation peak"
              f" unchunked {bpeak0} B (predicted {r.baseline_peak} B), chunked {bpeak1} B"
              f" (predicted {r.final_peak} B, {bpeak1 / r.final_peak:.4f}x); per-block vs"
              f" unchunked logits max_abs_err {err:.3e}"
              f"{' (limit 1e-3)' if dt_name == 'float32' else ''}; {card}")
        check(d["kernel_dispatch_hits"] == 2 and d["kernel_dispatch_misses"] == 0,
              f"phi3 {dt_name} dispatch: {d['kernel_dispatch_hits']} hits,"
              f" {d['kernel_dispatch_misses']} misses; want attention and SwiGLU, no miss")
        check(set(loops) == {"attention", "swiglu"}, f"phi3 {dt_name}: dispatched loops {loops}")
        check(n_ffn == L * swiglu[1] > 0,
              f"phi3 {dt_name}: chunked_ffn launched {n_ffn} times, want {L} x {swiglu[1]}")
        check(n_attn == L * attn[1] > 0 and n_masked == 0,
              f"phi3 {dt_name}: computed_attention launched {n_attn} times (masked"
              f" {n_masked}), want {L} x {attn[1]}")
        check(abs(bpeak1 - r.final_peak) <= 0.05 * r.final_peak,
              f"phi3 {dt_name}: chunked block peak {bpeak1} B is not within 5% of the"
              f" predicted {r.final_peak} B")
        if dt_name == "float32":
            check(err <= 1e-3, f"phi3 fp32 per-block logits differ by {err}")
        out[dt_name] = dict(launches=n_ffn, attention_launches=n_attn, swiglu_chunk=swiglu[0],
                            attention_chunk=attn[0], attention_chunks=attn[1],
                            stages=len(r.plan), logits_err=err, seconds=secs, ms=ms1,
                            pred_block0=r.baseline_peak, pred_block1=r.final_peak,
                            block_peak0=bpeak0, block_peak1=bpeak1)
        del model, cf, p0, h0
        M._AC_CACHE.clear()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The SSM and hybrid paths: mamba2-1.3b's forward on ssd_scan, and
# recurrentgemma-9b's on rglru_scan
# ---------------------------------------------------------------------------

SSM_RUN = dict(arch="mamba2-1.3b", seq_len=8192,
               # the loosest round ratio whose block plan chunks something
               # (the port estimator on meta: 2 stages, 473 -> 403 MiB)
               budget=0.9,
               # depth of the float32 and bf16 checks
               check_layers=4)
HYBRID_RUN = dict(arch="recurrentgemma-9b", seq_len=8192,
                  # two RG-LRU layers and one local attention
                  check_layers=3,
                  # the per-block budget: the attention block's plan chunks
                  # its attention (2 chunks of 4096 rows on meta)
                  budget=0.1)
UNIT_ROUNDOFF = 2.0 ** -24       # float32
# every kernel of each scan (ssd_scan_mma_kernel, ssd_scan_kernel<float>;
# rglru_scan_kernel<T>, rglru_scan_simple_kernel<T>)
SSM_KERNELS = {"ssd_scan": ("ssd_scan_",), "cuBLAS products": ("gemm", "nvjet")}
HYBRID_KERNELS = {"rglru_scan": ("rglru_scan_",), "computed_attention": ("chunk_attention",),
                  "cuBLAS products": ("gemm", "nvjet")}


def scan_tol(dt_name, terms, want):
    """The f32 limit of a scan: 2 * terms * u * max|want| (u = 2^-24), the
    worst-case rounding, in each of the two implementations, of a result
    made of ``terms`` roundings the size of the largest output.  bf16
    outputs add the bf16 limit of PERF.md section 2 (one unit in the last
    place)."""
    f32 = 2 * terms * UNIT_ROUNDOFF * float(want.float().abs().max())
    why = f"2 x {terms:.0f} x u x max|want|"
    if dt_name == "float32":
        return (f32, 0.0), f" ({why})"
    atol, rtol = TOL["bfloat16"]
    return (atol + f32, rtol), f" ({atol:g} + {why})"


def chunk_cumsums(torch, dt, A, q):
    """(max |a_cum|, max exp(a_end)) of an SSD call: a_cum is the cumulative
    sum of A * dt within each chunk of q rows, a_end its last row.  Both
    versions take exp of differences of such sums, whose f32 rounding is a
    relative error of about u |a_cum| on each decay factor; exp(a_end) is
    the weight with which the carried state reaches the next chunk."""
    s = dt.shape[1]
    a = torch.nn.functional.pad(A * dt, (0, 0, 0, (-s) % q))
    a_cum = a.reshape(a.shape[0], -1, q, a.shape[2]).cumsum(2)
    return float(a_cum.abs().max()), float(torch.exp(a_cum[:, :, -1]).max())


def ssd_needed_ops(b, s, h, p, n, q):
    """Operations the SSD function needs: C Bᵀ once per (b, chunk) (B and C
    are one per sequence, shared by the heads: 2Q²N), then per (b, h, chunk)
    the scores times x (2Q²P), the inter-chunk term and the state update
    (2QNP each).  The kernel recomputes C Bᵀ per head (``SS.flops``)."""
    nc = -(-s // q)
    return float(b * nc * 2 * q * q * n + b * h * nc * (2 * q * q * p + 4 * q * n * p))


def ssd_case(torch, b, s, h, p, n, dtype, seed, init="wide"):
    """Inputs shaped as the SSM block hands them over: x, B and C column
    views of one silu'd (b, s, h*p + 2n) conv output, dt after softplus in
    f32.  ``init="wide"``: dt = softplus(N(0, 1) - 1), A = -exp(U(0, 2)),
    whose chunk decays exp(a_end) are far below f32's reach at chunk 128.
    ``init="mamba2"``: Mamba-2's published initialisation (arXiv:2405.21060),
    dt log-uniform in [1e-3, 1e-1] and A = -U(1, 16), so that the carried
    state reaches the next chunk with a weight f32 can see."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    di = h * p
    conv = torch.nn.functional.silu(
        torch.randn((b, s, di + 2 * n), generator=g, device="cuda")).to(dtype)
    if init == "mamba2":
        u = torch.rand((b, s, h), generator=g, device="cuda")
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        A = -(1.0 + 15.0 * torch.rand((h,), generator=g, device="cuda"))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, h), generator=g, device="cuda") - 1.0)
        A = -torch.exp(torch.rand((h,), generator=g, device="cuda") * 2.0)
    return (conv[..., :di].reshape(b, s, h, p), dt, A, conv[..., di:di + n],
            conv[..., di + n:])


def check_ssd_kernel(torch, SS, cases, card):
    """The kernel against its plain version on the card: y and the final
    state, x/B/C in f32 and in bf16 (dt f32), for cases (b, s, h, p, n,
    chunk, init) with ``init`` as in :func:`ssd_case`.  Returns max errors
    by dtype."""
    errs = {}
    for dt_name in ("float32", "bfloat16"):
        for i, (b, s, h, p, n, q, init) in enumerate(cases):
            x, dt, A, B, C = ssd_case(torch, b, s, h, p, n, getattr(torch, dt_name), 300 + i,
                                      init)
            y, st = SS.ssd_scan(x, dt, A, B, C, chunk=q)
            torch.cuda.synchronize()
            y0, st0 = SS.ssd_scan_plain(x, dt, A, B, C, min(q, s))
            torch.cuda.synchronize()
            acum, carry = chunk_cumsums(torch, dt, A, min(q, s))
            label = (f"{dt_name} {init} b={b} s={s} h={h} p={p} n={n} chunk={q}"
                     f" max|a_cum|={acum:.1f} max exp(a_end)={carry:.3e}")
            # a y element sums q intra-chunk and n inter-chunk terms, each
            # under a decay factor exp(a_cum[i] - a_cum[j]) whose exponent
            # carries the cumulative sums' rounding; the state likewise
            terms = q + n + acum
            tol, why = scan_tol(dt_name, terms, y0)
            err = compare(torch, "ssd_scan", f"y {label}", y, y0, tol, f"{why}; {card}")
            tol, why = scan_tol("float32", terms, st0)
            err_st = compare(torch, "ssd_scan", f"state {label}", st, st0, tol, f"{why}; {card}")
            errs[dt_name] = max(errs.get(dt_name, 0.0), err)
            errs["state"] = max(errs.get("state", 0.0), err_st)
            del x, dt, A, B, C, y, st, y0, st0
    return errs


def check_rglru_kernel(torch, RS, shapes, card):
    """The kernel against its plain version on the card, f32 and bf16 a and
    b (the output is f32 either way): both round the product before the
    sum, so they agree bit for bit; the limit is PERF.md's f32 one."""
    errs = {}
    for dt_name in ("float32", "bfloat16"):
        for i, (B, S, D) in enumerate(shapes):
            g = torch.Generator(device="cuda").manual_seed(400 + i)
            a = torch.sigmoid(torch.randn((B, S, D), generator=g, device="cuda") + 2.0)
            b = torch.randn((B, S, D), generator=g, device="cuda") * 0.3
            a, b = a.to(getattr(torch, dt_name)), b.to(getattr(torch, dt_name))
            h = RS.rglru_scan(a, b)
            torch.cuda.synchronize()
            h0 = RS.rglru_scan_plain(a, b)
            check(h.dtype == torch.float32, f"rglru_scan returned {h.dtype}")
            err = compare(torch, "rglru_scan", f"{dt_name} B={B} S={S} D={D}", h, h0,
                          TOL["float32"], f"; bit-equal {torch.equal(h, h0)}; {card}")
            errs[dt_name] = max(errs.get(dt_name, 0.0), err)
            del a, b, h, h0
    return errs


def run_plain(SS, RS, fn, *args):
    """``fn(*args)`` with each scan's plain version put where the models call
    the kernel op (this script's comparisons; the package has no switch)."""
    kernels = (SS.ssd_scan, RS.rglru_scan)
    SS.ssd_scan = lambda x, dt, A, B, C, *, chunk=128: SS.ssd_scan_plain(
        x, dt, A, B, C, min(chunk, x.shape[1]))
    RS.rglru_scan = lambda a, b, *, chunk=256: RS.rglru_scan_plain(a, b)
    try:
        return fn(*args)
    finally:
        SS.ssd_scan, RS.rglru_scan = kernels


def run_ssm_forward(torch, SS, RS, stats, M, card):
    """mamba2-1.3b at full width and depth (48 layers, bf16, S 8192): the
    unchunked forward and the per-block forward under SSM_RUN's budget,
    each with the launch count zeroed just before and read just after; one
    block's measured peaks against the predicted ones; one block with the
    plain version swapped in; the device time split."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.graph import op_name

    cfg = get_config(SSM_RUN["arch"])
    cfg_ac = cfg.with_(autochunk_budget=SSM_RUN["budget"])
    S, L = SSM_RUN["seq_len"], cfg.n_layers
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(8), device="cuda")
    batch = {"tokens": torch.tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, S)), device="cuda")}

    def unchunked():
        return M.forward(cfg, model, batch)[0]

    def per_block():
        return M.forward(cfg_ac, model, batch)[0]

    unchunked()                                           # warm-up
    SS.ssd_scan.launches = 0
    y0, peak0, ms0 = measure_forward(torch, unchunked, ())
    n0 = SS.ssd_scan.launches
    check(n0 == L, f"unchunked mamba2 forward: ssd_scan launched {n0} times, want {L}")
    check(bool(torch.isfinite(y0[..., :cfg.vocab_size]).all()), "non-finite mamba2 logits")

    M._AC_CACHE.clear()
    before = stats.snapshot()
    t0 = time.perf_counter()
    y = per_block()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    d = stats.delta(before)
    del y
    (cf,) = M._AC_CACHE.values()
    r = cf.autochunk_result
    check(cf.counters["compiles"] == 1 and cf.counters["shape_hits"] == L - 1,
          f"first per-block forward: {cf.stats()}, want 1 compile and {L - 1} replays")
    check(d["plan_bucket_misses"] == 1, f"{d['plan_bucket_misses']} bucket misses, want 1")
    check(r.plan, "the block plan chunks nothing")
    print(f"[ssm] mamba2-1.3b L={L} d={cfg.d_model} H={cfg.ssm_heads} P={cfg.ssm_head_dim}"
          f" N={cfg.ssm_state} chunk={cfg.ssm_chunk} {cfg.dtype} S={S} budget"
          f" {SSM_RUN['budget']}: first per-block forward {first_s:.2f}s, one block compile"
          f" (host seconds trace {r.trace_s:.2f}, search {r.search_s:.2f}, compile"
          f" {r.elapsed_s - r.trace_s - r.search_s:.2f}; {d['search_passes']} search passes),"
          f" {len(r.plan)} stages, {cf.counters['compiles']} search and"
          f" {cf.counters['shape_hits']} replays; predicted block peak {r.baseline_peak} B ->"
          f" {r.final_peak} B (budget {r.budget_bytes} B, {r.reduction:.1%} reduction); {card}")
    for line in r.report().splitlines()[6:]:
        print(f"[ssm] {line.strip()}")

    # the bucket's plan replayed on layer 0: the scan is one op node in it
    p0 = M._index_tree(model["blocks"], 0)
    h0 = M.embed_inputs(cfg, model, batch)[0]
    before = stats.snapshot()
    planned = cf.trace(p0, h0).search()
    check(stats.delta(before)["search_passes"] == 0, "the replay searched")
    n_ops = sum(op_name(n) == "ssd_scan" for n in planned.graph.nodes)
    check(n_ops == 1, f"{n_ops} ssd_scan nodes in the compiled block, want 1")
    del planned

    # one block's activation peak: unchunked, chunked, and the plain version
    def block(p, x):
        return M.ssm_block_full(cfg, p, x)

    with torch.no_grad():
        block(p0, h0)
        _, bpeak0, bms0 = measure_forward(torch, block, (p0, h0))
        _, bpeak1, bms1 = measure_forward(torch, cf, (p0, h0))
        _, bpeak_p, bms_p = run_plain(SS, RS, measure_forward, torch, block, (p0, h0))
    print(f"[ssm] layer 0 activation peak: unchunked {bpeak0} B (predicted {r.baseline_peak} B,"
          f" {bpeak0 / r.baseline_peak:.4f}x), chunked {bpeak1} B (predicted {r.final_peak} B,"
          f" {bpeak1 / r.final_peak:.4f}x); the unchunked block with the plain SSD swapped in"
          f" {bpeak_p} B ({bpeak_p / bpeak0:.2f}x the kernel's); time unchunked {bms0:.2f} ms,"
          f" chunked {bms1:.2f} ms, plain {bms_p:.2f} ms; {card}")
    check(abs(bpeak1 - r.final_peak) <= 0.05 * r.final_peak,
          f"chunked block peak {bpeak1} B is not within 5% of the predicted {r.final_peak} B")

    hits = cf.counters["shape_hits"]
    before = stats.snapshot()
    SS.ssd_scan.launches = 0
    y1, peak1, ms1 = measure_forward(torch, per_block, ())
    n1 = SS.ssd_scan.launches
    d = stats.delta(before)
    check(d["search_passes"] == 0 and cf.counters["shape_hits"] - hits == L,
          f"second per-block forward: {d['search_passes']} search passes,"
          f" {cf.counters['shape_hits'] - hits} replays")
    check(n1 == L, f"per-block mamba2 forward: ssd_scan launched {n1} times, want {L}")
    check(bool(torch.isfinite(y1[..., :cfg.vocab_size]).all()), "non-finite per-block logits")
    bf16_err = max_logit_err(y1, y0, cfg.vocab_size)
    print(f"[forward] mamba2-1.3b: whole-forward peak unchunked {peak0} B, per block {peak1} B;"
          f" time unchunked {ms0:.2f} ms, per block {ms1:.2f} ms; ssd_scan launches {n0}"
          f" unchunked, {n1} per block = {L} layers x 1; bf16 logits max |delta| per block vs"
          f" unchunked {bf16_err:.3e}; {card}")
    del y0, y1
    trace = device_time_split(torch, unchunked, card, "mamba2-1.3b unchunked forward",
                              SSM_KERNELS)
    del model, p0, h0, cf
    M._AC_CACHE.clear()
    return dict(launches=n0, per_block_launches=n1, stages=len(r.plan),
                pred_block0=r.baseline_peak, pred_block1=r.final_peak, block_peak0=bpeak0,
                block_peak1=bpeak1, block_peak_plain=bpeak_p, peak0=peak0, peak1=peak1,
                ms0=ms0, ms1=ms1, bf16_logits_err=bf16_err, trace_s=r.trace_s,
                search_s=r.search_s, device_ms=trace)


def check_logits_against_plain(torch, SS, RS, M, arch, layers, seed, card, *, bf16):
    """At full width, ``layers`` deep, S 8192: the float32 logits with the
    kernels against those with the plain versions swapped in (1e-3).  With
    ``bf16``, also the bf16 logits of the same weights (``init_params``
    draws in f32 and rounds) against the float32 plain ones: with the
    kernels no further than 1.5 times the plain bf16 logits are."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(arch).with_(dtype="float32", n_layers=layers)
    S = SSM_RUN["seq_len"]
    batch = {"tokens": torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, S)), device="cuda")}

    def logits(c):
        model = M.init_params(c, torch.Generator(device="cuda").manual_seed(seed),
                              device="cuda")
        y = M.forward(c, model, batch)[0]
        yp = run_plain(SS, RS, M.forward, c, model, batch)[0]
        return y, yp

    y32, y32p = logits(cfg)
    err = max_logit_err(y32, y32p, cfg.vocab_size)
    print(f"[forward] {arch} fp32 L={layers} S={S}: logits with the kernels vs the plain"
          f" versions swapped in max_abs_err {err:.3e} (limit 1e-3); {card}")
    check(err <= 1e-3, f"{arch} fp32 logits differ from the plain versions' by {err}")
    out = dict(fp32_logits_err=err)
    del y32
    if bf16:
        y16, y16p = logits(cfg.with_(dtype="bfloat16"))
        err_k = max_logit_err(y16, y32p, cfg.vocab_size)
        err_p = max_logit_err(y16p, y32p, cfg.vocab_size)
        print(f"[forward] {arch} bf16 L={layers} S={S} against the float32 logits of the same"
              f" weights: with the kernels max_abs_err {err_k:.3e}, plain versions"
              f" {err_p:.3e} ({err_k / err_p:.3f}x; limit 1.5x); {card}")
        check(err_k <= 1.5 * err_p, f"{arch} bf16 logits stray {err_k} from float32, the"
              f" plain versions' {err_p}")
        out.update(bf16_vs_fp32_kernel=err_k, bf16_vs_fp32_plain=err_p)
        del y16, y16p
    del y32p
    return out


def run_hybrid_forward(torch, RS, M, card):
    """recurrentgemma-9b at full width and depth (38 layers, bf16, S 8192):
    the forward with the launch count zeroed just before and read just
    after, its RG-LRU layers on ``rglru_scan``; the device time split."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(HYBRID_RUN["arch"])
    S, L = HYBRID_RUN["seq_len"], cfg.n_layers
    n_rg = sum(not cfg.is_attention_layer(i) for i in range(L))
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(9), device="cuda")
    batch = {"tokens": torch.tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, S)), device="cuda")}

    def fwd():
        return M.forward(cfg, model, batch)[0]

    fwd()                                                 # warm-up
    RS.rglru_scan.launches = 0
    y, peak, ms = measure_forward(torch, fwd, ())
    n = RS.rglru_scan.launches
    check(n == n_rg, f"recurrentgemma forward: rglru_scan launched {n} times, want {n_rg}")
    check(bool(torch.isfinite(y[..., :cfg.vocab_size]).all()), "non-finite hybrid logits")
    n_params = sum(t.numel() for t in model.parameters())
    print(f"[forward] recurrentgemma-9b L={L} ({n_rg} RG-LRU, {L - n_rg} local attention)"
          f" d={cfg.d_model} {cfg.dtype} S={S}, {n_params} parameters: time {ms:.2f} ms,"
          f" activation peak {peak} B; rglru_scan launches {n} = {n_rg} RG-LRU layers x 1;"
          f" {card}")
    del y
    trace = device_time_split(torch, fwd, card, "recurrentgemma-9b forward", HYBRID_KERNELS)
    del model
    return dict(launches=n, ms=ms, peak=peak, device_ms=trace)


def run_hybrid_budget(torch, CA, RS, stats, M, card):
    """recurrentgemma-9b at full width and depth (38 layers, bf16, S 8192)
    under HYBRID_RUN's budget: one plan for the local attention block
    (``hyb_attn``, its attention on ``computed_attention`` at hd 256) and
    one for the RG-LRU block (``hyb_rg``, its scan one ``rglru_scan`` op
    node), each compiled at the first layer of its kind; each plan's
    predicted and measured peaks on that layer; the whole forward
    unbudgeted and per block with the launch counts zeroed just before and
    read just after; the device time split."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.graph import op_name
    from repro_torch.core.lowering import is_chunk_loop

    cfg = get_config(HYBRID_RUN["arch"])
    cfg_ac = cfg.with_(autochunk_budget=HYBRID_RUN["budget"])
    S, L = HYBRID_RUN["seq_len"], cfg.n_layers
    kinds = {"hyb_attn": [i for i in range(L) if cfg.is_attention_layer(i)],
             "hyb_rg": [i for i in range(L) if not cfg.is_attention_layer(i)]}
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(9), device="cuda")
    batch = {"tokens": torch.tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, S)), device="cuda")}

    def unchunked():
        return M.forward(cfg, model, batch)[0]

    def per_block():
        return M.forward(cfg_ac, model, batch)[0]

    M._AC_CACHE.clear()
    before = stats.snapshot()
    t0 = time.perf_counter()
    y = per_block()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    d = stats.delta(before)
    del y
    cfs = {key[2]: cf for key, cf in M._AC_CACHE.items()}
    check(set(cfs) == set(kinds), f"per-block plans {sorted(cfs)}, want {sorted(kinds)}")
    print(f"[block] recurrentgemma-9b L={L} d={cfg.d_model} H={cfg.n_heads} Kv={cfg.n_kv_heads}"
          f" hd={cfg.hd} window={cfg.local_window} {cfg.dtype} S={S} budget"
          f" {HYBRID_RUN['budget']}: first per-block forward {first_s:.2f}s with both block"
          f" compiles ({d['search_passes']} search passes); dispatch hits"
          f" {d['kernel_dispatch_hits']} (computed mask {d['kernel_dispatch_computed_mask']}),"
          f" misses {d['kernel_dispatch_misses']}; {card}")
    h0 = M.embed_inputs(cfg, model, batch)[0]
    blocks = {"hyb_attn": lambda p, x: M.dense_block_full(cfg, p, x, window=cfg.local_window),
              "hyb_rg": lambda p, x: M.rg_block_full(cfg, p, x)}
    out = {}
    for tag, layers in kinds.items():
        cf, r = cfs[tag], cfs[tag].autochunk_result
        check(cf.counters["compiles"] == 1 and cf.counters["shape_hits"] == len(layers) - 1,
              f"{tag}: {cf.stats()}, want 1 compile and {len(layers) - 1} replays")
        p0 = M._index_tree(model["blocks"][layers[0]])
        before = stats.snapshot()
        planned = cf.trace(p0, h0).search()
        check(stats.delta(before)["search_passes"] == 0, f"{tag}: the replay searched")
        loops = [(n.params["c"], n.params["n_iters"], [k.kind for k in n.params["dispatches"]])
                 for n in planned.graph.nodes if is_chunk_loop(n)]
        n_scan = sum(op_name(n) == "rglru_scan" for n in planned.graph.nodes)
        del planned
        with torch.no_grad():
            blocks[tag](p0, h0)
            _, bpeak0, bms0 = measure_forward(torch, blocks[tag], (p0, h0))
            _, bpeak1, bms1 = measure_forward(torch, cf, (p0, h0))
        print(f"[block] {tag}: one compile (host seconds trace {r.trace_s:.2f}, search"
              f" {r.search_s:.2f}, compile {r.elapsed_s - r.trace_s - r.search_s:.2f}),"
              f" {cf.counters['shape_hits']} replays over layers {layers[0]}..{layers[-1]};"
              f" {len(r.plan)} stages, loops (rows, chunks, dispatched) {loops}; rglru_scan op"
              f" nodes {n_scan}; layer {layers[0]} activation peak unchunked {bpeak0} B"
              f" (predicted {r.baseline_peak} B, {bpeak0 / r.baseline_peak:.4f}x), chunked"
              f" {bpeak1} B (predicted {r.final_peak} B, budget {r.budget_bytes} B,"
              f" {bpeak1 / r.final_peak:.4f}x); time unchunked {bms0:.2f} ms, chunked"
              f" {bms1:.2f} ms; {card}")
        for line in r.report().splitlines()[6:]:
            print(f"[block] {tag} {line.strip()}")
        check(abs(bpeak1 - r.final_peak) <= 0.05 * r.final_peak,
              f"{tag}: chunked block peak {bpeak1} B is not within 5% of the predicted"
              f" {r.final_peak} B")
        check(n_scan == (1 if tag == "hyb_rg" else 0), f"{tag}: {n_scan} rglru_scan nodes")
        out[tag] = dict(stages=len(r.plan), loops=loops, pred_block0=r.baseline_peak,
                        pred_block1=r.final_peak, budget_bytes=r.budget_bytes,
                        block_peak0=bpeak0, block_peak1=bpeak1, block_ms0=bms0,
                        block_ms1=bms1, trace_s=r.trace_s, search_s=r.search_s)
    attn_loops = [lp for lp in out["hyb_attn"]["loops"] if "attention" in lp[2]]
    check(len(attn_loops) == 1, f"hyb_attn: attention loops {out['hyb_attn']['loops']}")
    rows, chunks = attn_loops[0][:2]

    unchunked()
    y0, peak0, ms0 = measure_forward(torch, unchunked, ())
    before = stats.snapshot()
    CA.computed_attention.launches = CA.masked_attention.launches = RS.rglru_scan.launches = 0
    y1, peak1, ms1 = measure_forward(torch, per_block, ())
    n_attn, n_scan = CA.computed_attention.launches, RS.rglru_scan.launches
    d = stats.delta(before)
    n_att_layers, n_rg = len(kinds["hyb_attn"]), len(kinds["hyb_rg"])
    check(d["search_passes"] == 0, f"second per-block forward: {d['search_passes']} searches")
    check(n_attn == n_att_layers * chunks > 0 and CA.masked_attention.launches == 0,
          f"computed_attention launched {n_attn} times, want {n_att_layers} x {chunks}")
    check(n_scan == n_rg, f"rglru_scan launched {n_scan} times, want {n_rg}")
    check(bool(torch.isfinite(y1[..., :cfg.vocab_size]).all()), "non-finite per-block logits")
    check(peak1 < peak0, f"per-block peak {peak1} B is not below the unbudgeted {peak0} B")
    err = max_logit_err(y1, y0, cfg.vocab_size)
    print(f"[forward] recurrentgemma-9b per block: whole-forward peak unchunked {peak0} B, per"
          f" block {peak1} B; time unchunked {ms0:.2f} ms, per block {ms1:.2f} ms;"
          f" computed_attention launches {n_attn} = {n_att_layers} attention layers x {chunks}"
          f" chunks of {rows} rows, rglru_scan launches {n_scan} = {n_rg} RG-LRU layers x 1;"
          f" bf16 logits max |delta| per block vs unchunked {err:.3e}; {card}")
    del y0, y1
    trace = device_time_split(torch, per_block, card, "recurrentgemma-9b per-block forward",
                              HYBRID_KERNELS)
    del model, h0
    M._AC_CACHE.clear()
    return dict(budget=HYBRID_RUN["budget"], blocks=out, attention_launches=n_attn,
                attention_chunk=rows, attention_chunks=chunks, launches=n_scan, peak0=peak0,
                peak1=peak1, ms0=ms0, ms1=ms1, bf16_logits_err=err, device_ms=trace)


def check_hybrid_budget_logits(torch, M, card):
    """At full width, HYBRID_RUN's check depth (two RG-LRU layers, one local
    attention), S 8192: per-block float32 logits within 1e-3 of the
    unbudgeted ones; then the bf16 logits of the same weights against the
    unbudgeted float32 ones, per block no further than 1.5 times unbudgeted."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(HYBRID_RUN["arch"]).with_(dtype="float32",
                                                n_layers=HYBRID_RUN["check_layers"])
    S, L = HYBRID_RUN["seq_len"], cfg.n_layers
    batch = {"tokens": torch.tensor(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (1, S)), device="cuda")}

    def logits(c):
        model = M.init_params(c, torch.Generator(device="cuda").manual_seed(13),
                              device="cuda")
        M._AC_CACHE.clear()
        y0 = M.forward(c, model, batch)[0]
        y1 = M.forward(c.with_(autochunk_budget=HYBRID_RUN["budget"]), model, batch)[0]
        M._AC_CACHE.clear()
        return y0, y1

    y32, y32b = logits(cfg)
    err = max_logit_err(y32b, y32, cfg.vocab_size)
    print(f"[forward] recurrentgemma-9b per-block fp32 L={L} S={S} budget {HYBRID_RUN['budget']}:"
          f" per-block vs unchunked logits max_abs_err {err:.3e} (limit 1e-3); {card}")
    check(err <= 1e-3, f"recurrentgemma fp32 per-block logits differ by {err}")
    del y32b
    y16, y16b = logits(cfg.with_(dtype="bfloat16"))
    err_u = max_logit_err(y16, y32, cfg.vocab_size)
    err_b = max_logit_err(y16b, y32, cfg.vocab_size)
    print(f"[forward] recurrentgemma-9b bf16 L={L} S={S} against the float32 logits of the same"
          f" weights: unchunked max_abs_err {err_u:.3e}, per block {err_b:.3e}"
          f" ({err_b / err_u:.3f}x; limit 1.5x); {card}")
    check(err_b <= 1.5 * err_u, f"recurrentgemma bf16 per-block logits stray {err_b} from"
          f" float32, the unchunked ones {err_u}")
    del y32, y16, y16b
    return dict(fp32_logits_err=err, bf16_vs_fp32_unchunked=err_u, bf16_vs_fp32_per_block=err_b)


def time_scans(torch, SS, RS, flush, card):
    """Each scan at its model's shape, CUDA-event medians with L2 flushed,
    beside its bound and its plain version (no one PyTorch call computes
    either function, so there is no library time)."""
    from repro_torch.configs import get_config

    out = {}
    mcfg = get_config(SSM_RUN["arch"])
    b, s, h, p, n, q = (1, SSM_RUN["seq_len"], mcfg.ssm_heads, mcfg.ssm_head_dim,
                        mcfg.ssm_state, mcfg.ssm_chunk)
    x, dt, A, B, C = ssd_case(torch, b, s, h, p, n, torch.bfloat16, seed=7)
    nbytes = (2 * b * s * h * p * 2 + b * s * h * 4 + 2 * b * s * n * 2 + h * 4
              + b * h * p * n * 4)                 # x and y, dt, B and C, A, state
    ops = ssd_needed_ops(b, s, h, p, n, q)
    out["ssd_scan"] = dict(
        ms=time_ms(torch, lambda: SS.ssd_scan(x, dt, A, B, C, chunk=q), flush),
        plain_ms=time_ms(torch, lambda: SS.ssd_scan_plain(x, dt, A, B, C, q), flush),
        library_ms=None, shape=dict(b=b, s=s, h=h, p=p, n=n, chunk=q, dtype="bfloat16"),
        **bound(nbytes, ops))
    del x, dt, A, B, C
    Bn, S, D = 1, HYBRID_RUN["seq_len"], get_config(HYBRID_RUN["arch"]).d_model
    g = torch.Generator(device="cuda").manual_seed(7)
    a = torch.sigmoid(torch.randn((Bn, S, D), generator=g, device="cuda") + 2.0)
    bb = torch.randn((Bn, S, D), generator=g, device="cuda") * 0.3
    out["rglru_scan"] = dict(
        ms=time_ms(torch, lambda: RS.rglru_scan(a, bb), flush),
        plain_ms=time_ms(torch, lambda: RS.rglru_scan_plain(a, bb), flush, reps=5),
        library_ms=None, shape=dict(B=Bn, S=S, D=D, dtype="float32"),
        **bound(3 * Bn * S * D * 4, 2 * Bn * S * D))
    del a, bb
    for name, t in out.items():
        print(f"[time] {name} {t['shape']}: kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f}"
              f" ms ({t['bound_by']}; {t['bytes']} B, {t['operations']:.0f} ops), plain"
              f" {t['plain_ms']:.4f} ms, library: none in one call,"
              f" {t['bound_ms'] / t['ms']:.1%} of bound; {card}")
    return out


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

    sources = ("paged_attention", "chunked_attention", "chunked_ffn", "ssd_scan", "rglru_scan")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(timed_build, sources)))
    for name, (log, seconds) in builds.items():
        print(f"[build] {name}.cu with nvcc in {seconds:.2f}s")
        ptxas_report(name, log)
    # which route each redesigned kernel took: tensor-core instructions in
    # its SASS (the bf16 attention and FFN kernels must have HGMMA, the bf16
    # SSD kernel HMMA or HGMMA, the f32 ones, the mask's tile pre-pass and
    # the RG-LRU kernels none)
    routes = {"chunked_attention": route_report(build, "chunked_attention", {
                  "chunk_attention_wgmma_kernel": True,     # bf16, computed and masked
                  "chunk_attention_kernel<": False, "mask_": False}),
              "paged_attention": route_report(build, "paged_attention", {}),
              "chunked_ffn": route_report(build, "chunked_ffn", {
                  "ffn_wgmma_kernel": True, "ffn_simt_kernel": False, "cast_bf16": False}),
              # the bf16 scan on mma.sync (HMMA), the f32 one on CUDA cores
              "ssd_scan": route_report(build, "ssd_scan", {
                  "ssd_scan_mma_kernel": "tensor cores", "ssd_scan_kernel<": False}),
              "rglru_scan": route_report(build, "rglru_scan", {"rglru_scan": False})}

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
        # phi3-mini-3.8b's heads (hd 96) at the same serving steps
        "phi3_serve_decode": dict(serve_decode, H=32, Kv=32, hd=96),
        "phi3_mixed": dict(mixed, H=32, Kv=32, hd=96),
    }
    max_err, cases = check_paged_kernel(torch, PA, {**shapes, **PAGED_EDGE_SHAPES}, ps, L_max)

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
    wall, launches, d, steps, toks = serve_timed(torch, PA, stats, engine, cfg, reqs)
    ttft = [r.ttft_s for r in reqs]
    print(f"[serve] gpt-paper bf16 full width: {len(reqs)} requests (prompts"
          f" {lens[0]}..{lens[-1]}), {toks} tokens in {wall:.3f}s = {toks / wall:.1f} tok/s,"
          f" {steps} steps ({engine.sched_stats['mixed_steps']} mixed), TTFT mean"
          f" {statistics.mean(ttft):.3f}s max {max(ttft):.3f}s")
    print(f"[serve] planned prefill chunk {chunk} at budget {SERVE['budget']}: predicted"
          f" one-block peak {plan.peak_bytes} B of budget {plan.budget_bytes} B"
          f" (unchunked {plan.baseline_peak_bytes} B)")
    print(f"[serve] paged_attention launches {launches} = {cfg.n_layers} layers x {steps}"
          f" steps; pages allocated {d['pages_allocated']} freed {d['pages_freed']};"
          f" sched_stats {dict(engine.sched_stats)}; served tokens sha256"
          f" {token_digest(reqs)}")

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
        # the split kernel and, at decode, its merge
        attn = sum(us for n, us in device_us.items() if "paged_attention" in n) / 1e6
        print(f"[trace] serving window on the device: busy {busy:.4f}s of the untraced"
              f" {wall:.4f}s wall (idle {1 - busy / wall:.1%}); paged_attention kernels"
              f" {attn:.4f}s = {attn / wall:.1%} of wall, {attn / busy:.1%} of busy; {card}")
        for n, us in device_us.most_common(8):
            print(f"[trace]   {us / 1e3:10.3f} ms  {n[:100]}")

    # ---- 4c. the same requests with the plain version swapped in ---------
    # which served tokens the kernel's rounding changed, if any
    plain_reqs, same = serve_plain_swapped(PA, engine, reqs)
    print(f"[serve] the same requests with the plain version swapped in: served tokens sha256"
          f" {token_digest(plain_reqs)}; {same} of {toks} tokens equal to the kernel's")
    del engine, params

    # ---- 4d. phi3-mini-3.8b served at full width: its hd 96 on the kernel -
    # (counts zeroed just before, read just after); hd 48 still refused
    torch.cuda.empty_cache()
    phi3_serve = serve_phi3(torch, PA, stats, M, lens, card)

    # ---- 5. served logits against the dense forward, fp32 ----------------
    # gpt-paper at full depth, phi3-mini at 4 layers
    prompt = rng.integers(0, cfg.vocab_size, 600).tolist()
    check_served_logits(torch, M, cfg.with_(dtype="float32"), 1, prompt)
    pcfg = get_config("phi3-mini-3.8b")
    phi3_serve["fp32_logits_err"] = check_served_logits(
        torch, M, pcfg.with_(dtype="float32", n_layers=4), 4,
        rng.integers(0, pcfg.vocab_size, 600).tolist(), label=f"phi3-mini-3.8b L=4 hd={pcfg.hd} ")

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
    timed = time_paged_kernel(torch, F, PA, {k: shapes[k] for k in
                                             ("gpt_decode", "gpt_serve_decode", "gpt_mixed",
                                              "phi3_serve_decode", "phi3_mixed")},
                              cases, flush, card)

    # ---- 8. the compiler path: autochunk on gpt-paper at full width ------
    # compile + drive (counts zeroed just before, read just after), for the
    # computed-mask kernel and then, under mask_mode="bool", the masked one;
    # each followed by the float32 check of chunked against unchunked logits
    from repro_torch.kernels import chunked_attention as CA

    cfg_c = cfg.with_(scan_layers=False)                  # 12 layers, bf16
    fwd = {}
    fp32_err = {}
    cold = {}
    for mode in ("auto", "bool"):
        fwd[mode] = run_compiled_forward(torch, CA, stats, M, cfg_c, card, mask_mode=mode,
                                         keep=cold if mode == "auto" else None)
        fp32_err[mode] = check_forward_fp32(torch, M, cfg_c, mask_mode=mode)
        torch.cuda.empty_cache()

    # ---- 8b. the plan cache: precompiled gpt-paper replayed from disk ----
    cache_run = run_cache_phase(torch, CA, stats, M, cfg_c, cold, card)
    del cold
    torch.cuda.empty_cache()

    # ---- 9. the chunked-attention kernels against their plain versions --
    c_chunk, ext = fwd["auto"]["chunk"], COMPILE["seq_len"]
    attn_err = check_attention_kernels(torch, CA, gpt_attention_cases(c_chunk, ext)
                                       + ATTENTION_EDGE_CASES + ATTENTION_HD_CASES)

    # ---- 10. their times at the compiled forward's chunk shape ----------
    attn_timed = time_attention_kernels(torch, F, CA, c_chunk, ext, flush, card, attn_err)

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
        torch, F, CA, ac["Sq"], ac["Skv"], flush, card, attn_err, N=ac["N"], group=ac["group"],
        hd=ac["hd"], names=("computed_attention",))["computed_attention"]

    # ---- 13. chunked_ffn against its plain version, then its time --------
    mcfg = get_config(BLOCK["arch"])
    ffn_err = check_ffn_kernel(torch, CF, mcfg, (block["chunk"],) + FFN_ROWS)
    ffn_timed = time_ffn_kernel(torch, F, CF, mcfg, block["chunk"], flush, card)
    del mcfg

    # ---- 13b. phi3-mini-3.8b per block: attention (hd 96) and MLP kernels --
    phi3 = run_phi3_forward(torch, CA, CF, stats, M, card)

    # ---- 14. the scan kernels against their plain versions ---------------
    # mamba2's full shape, a length the chunk does not divide, the reduced
    # config's chunk 16, a shape off every tile edge, and with Mamba-2's own
    # dt and A (where the carried state's weight exp(a_end) is visible in
    # f32) the full shape, 1000 rows and batch 2; recurrentgemma's shape, an
    # odd length, batch 2 and a ragged channel tile
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.kernels import ssd_scan as SS

    torch.cuda.empty_cache()
    scfg, hcfg = get_config(SSM_RUN["arch"]), get_config(HYBRID_RUN["arch"])
    full = (scfg.ssm_heads, scfg.ssm_head_dim, scfg.ssm_state)
    red = scfg.reduced()
    ssd_err = check_ssd_kernel(torch, SS, [
        (1, SSM_RUN["seq_len"], *full, scfg.ssm_chunk, "wide"),
        (1, 1000, *full, scfg.ssm_chunk, "wide"),
        (2, 100, red.ssm_heads, red.ssm_head_dim, red.ssm_state, red.ssm_chunk, "wide"),
        (1, SSM_RUN["seq_len"], *full, scfg.ssm_chunk, "mamba2"),
        (1, 1000, *full, scfg.ssm_chunk, "mamba2"),
        (2, SSM_RUN["seq_len"], *full, scfg.ssm_chunk, "mamba2"),
        # off every tile edge: a second p block of 16, n in one 64-column
        # box, a chunk of 100 and a ragged last chunk
        (1, 333, 4, 48, 64, 100, "wide")], card)
    # B 2, and a D that is no multiple of the kernel's 32-channel tile (f32:
    # TMA with a ragged last tile; bf16: rows of 8200 bytes, which TMA cannot
    # take, so the one-thread-a-channel kernel)
    rglru_err = check_rglru_kernel(torch, RS, [(1, HYBRID_RUN["seq_len"], hcfg.d_model),
                                               (1, 1001, hcfg.d_model),
                                               (2, 1001, hcfg.d_model),
                                               (1, 1001, hcfg.d_model + 4)], card)

    # ---- 15. mamba2-1.3b at full width: unchunked and per block ----------
    # counts zeroed just before each forward and read just after; then the
    # float32 and bf16 checks against the plain version at 4 layers
    ssm = run_ssm_forward(torch, SS, RS, stats, M, card)
    torch.cuda.empty_cache()
    ssm.update(check_logits_against_plain(torch, SS, RS, M, SSM_RUN["arch"],
                                          SSM_RUN["check_layers"], 10, card, bf16=True))
    torch.cuda.empty_cache()

    # ---- 16. recurrentgemma-9b at full width (the earlier models freed) --
    hyb = run_hybrid_forward(torch, RS, M, card)
    torch.cuda.empty_cache()
    hyb.update(check_logits_against_plain(torch, SS, RS, M, HYBRID_RUN["arch"],
                                          HYBRID_RUN["check_layers"], 11, card, bf16=False))
    torch.cuda.empty_cache()

    # ---- 16b. recurrentgemma-9b under a budget: both block kinds compiled --
    # counts zeroed just before the per-block forward and read just after;
    # then the float32 and bf16 checks at 3 layers
    hyb_budget = run_hybrid_budget(torch, CA, RS, stats, M, card)
    torch.cuda.empty_cache()
    hyb_budget.update(check_hybrid_budget_logits(torch, M, card))
    torch.cuda.empty_cache()

    # ---- 17. the scans' times at their models' shapes ---------------------
    scan_timed = time_scans(torch, SS, RS, flush, card)

    # ---- 17b. the attention kernels at the new head dims' model shapes ---
    # phi3-mini's per-block chunk (hd 96), recurrentgemma's (hd 256, MQA in
    # its window), hubert-xlarge's encoder attention (hd 80, not causal)
    hd_timed = {
        "phi3_hd96": time_attention_kernels(
            torch, F, CA, phi3["bfloat16"]["attention_chunk"], PHI3["seq_len"], flush, card,
            attn_err, N=32, hd=96),
        "recurrentgemma_hd256": time_attention_kernels(
            torch, F, CA, hyb_budget["attention_chunk"], HYBRID_RUN["seq_len"], flush, card,
            attn_err, N=hcfg.n_kv_heads, group=hcfg.n_heads // hcfg.n_kv_heads, hd=hcfg.hd,
            window=hcfg.local_window),
        "hubert_hd80": time_attention_kernels(torch, F, CA, 1024, 8192, flush, card, attn_err,
                                              N=16, hd=80, causal=False),
    }

    # ---- 18. kernels lines and the result --------------------------------
    launch_counts = {"paged_attention": launches,
                     "computed_attention": fwd["auto"]["launches"],
                     "masked_attention": fwd["bool"]["launches"],
                     "chunked_ffn": block["launches"],
                     "ssd_scan": ssm["launches"],
                     "rglru_scan": hyb["launches"]}
    errs = {"paged_attention": max_err, "chunked_ffn": ffn_err, "ssd_scan": ssd_err,
            "rglru_scan": rglru_err}
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
        "tensor_core_instructions": routes["paged_attention"],
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
    entries[0]["phi3_serve"] = phi3_serve
    entries[1]["cache"] = cache_run
    entries[1]["block_shape"] = block_attn_timed
    entries[1]["hybrid_budget_forward"] = hyb_budget
    entries[1]["phi3_forward"] = phi3
    for i, kname in ((1, "computed_attention"), (2, "masked_attention")):
        entries[i]["head_dim_shapes"] = {k: t[kname] for k, t in hd_timed.items()}
    entries[1]["tensor_core_instructions"] = routes["chunked_attention"]
    entries[2]["tensor_core_instructions"] = routes["chunked_attention"]
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
        "phi3_forward": phi3,
        "tensor_core_instructions": routes["chunked_ffn"],
    })
    for kname, line, run in (("ssd_scan", 78, ssm), ("rglru_scan", 49, hyb)):
        t = scan_timed[kname]
        entries.append({
            "name": kname,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": f"src/repro/kernels/{kname}.py:{line}",
            "launches": launch_counts[kname],
            "max_abs_err": errs[kname]["bfloat16"],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "max_err_bf16": errs[kname]["bfloat16"],
            "max_err_fp32": errs[kname]["float32"],
            "shape": dict(t["shape"], bytes=t["bytes"], operations=t["operations"]),
            "forward": run,
            "tensor_core_instructions": routes[kname],
        })
    entries[-2]["max_err_state_fp32"] = ssd_err["state"]
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
