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
and drives the port's paths, five at
gpt-paper's full width, one at minitron-4b's, four at phi3-mini-3.8b's,
two at mamba2-1.3b's, three at recurrentgemma-9b's, two at
qwen2-moe-a2.7b's and one at deepseek-v3-671b's:

* serving: the paged engine, its kernel held against its plain version at
  the serving shapes (gpt-paper's and phi3-mini's heads) and at edge cases
  (split decode batches with a row of q_len 0 and splits past kv_len, GQA
  hd 256, hd 96, and the prefix phase's prefill steps: a hit's 152 rows
  from position 1000, mid-page, padded to the 512-row chunk, and a miss's
  last 128 rows), the served tokens' digest beside those served with the
  plain version swapped in, the served logits against the dense forward;
  then phi3-mini-3.8b (hd 96) served the same way at full width, its fp32
  served logits at 4 layers against its dense forward, and a head dim the
  paged kernel has no instance for (48) refused when the engine is built;
* observability (``[obs]`` lines): phase 4's timed run as the engine
  records it (the tracer and registry reset just before it): one
  ``serve.step`` span a step and one TTFT observation a request, the host
  seconds of its admit, prefill-chunk and decode-wave spans beside phase
  4b's device busy time, the paged engine's ``plan_accuracy``, the trace
  summarised by ``python -m repro_torch.tools.trace_export`` in a
  subprocess; the host cost of one step's obs calls (at most 2% of the
  median step) and decode tok/s with obs on and off in turns; in
  ``[slot]``, the compiled wave's compile spans and its ``plan_accuracy``
  measured on the card, within 1% of this script's own peak around one
  wave, and the serving CLI's ``--metrics-out``, ``--trace-out`` and
  ``--prom-out`` files;
* the prefix cache and its host spill tier at phi3-mini's full width: 8
  requests of 1152 tokens sharing a 1000-token system prompt, served one
  by one, rids 2 and 5 uncached fillers that force cached pages into the
  pinned host arena (5 prefix hits, copy-on-write of each hit's boundary
  page, pages restored, no refusal, restored pages bit-equal to their bytes
  before the spill, invariants, nothing left after ``flush()``, paged
  launches 32 x steps; the paged kernel against its plain version, bf16
  and f32, on layer 0's own prefill inputs of a miss, the first hit and a
  hit over restored pages); TTFT beside the same requests with the cache off;
  equal float32 tokens and first-token logits within 1e-3 with the cache
  on and off at 4 layers; and the serving CLI's ``--shared-prefix``
  scenario at gpt-paper's width (its ``[serve] prefix:`` line);
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
  ``chunked_ffn``, the chunked block's peak within 5% of its prediction and
  its predicted peak within the budget, float32 per-block logits within
  1e-3 of the unchunked ones;
* the fixed-slot engine (``ServeEngine``) at phi3-mini's full width and
  depth, bf16: two 8128-token prompts decoding 128 tokens each past
  position 8192 through ring caches of the 8192-token window, and a
  1000-token request admitted into a freed slot; each prefill per block
  under budget 0.03 (its attention kernel and ``chunked_ffn`` launched 32 x
  the plan's chunks), the block plans' layer-0 peaks within 5% of their
  predictions, the attention kernel against its plain version on layer 0's
  own inputs of both prompt lengths, TTFT and tok/s, the requests again with
  the plain versions swapped in, the decode wave compiled at budget 0.5
  against the plain wave (bf16 ``TOL``) and reconfigured inside its bucket
  (1 bucket hit, no trace, no search), float32 logits at 4 layers within
  1e-3 of the windowed forward at the first wave, the wave that writes
  position 8192 and the last, and the serving CLI without ``--paged`` at
  gpt-paper's width (its second run reuses the warm wave);
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
  1.5 times the unbudgeted bf16 logits;
* the fixed-slot engine on both recurrent families (``[slot-ssm]``), bf16,
  full width and depth, 2 slots, three requests each (the third in a freed
  slot, over the first's state rows): mamba2-1.3b (prompts 8192, 1000 and
  2000; f32 SSD states and conv windows) and recurrentgemma-9b (prompts
  4096, 1000 and 600; RG-LRU states, and local-attention rings of 2048
  rolled at prefill); each prefill per block under its forward's budget
  (0.9, 0.1), the recurrent block under its own tag so that it hands back
  its scan's final state, with ``ssd_scan``, ``rglru_scan`` and
  ``computed_attention`` counted while serving; each block plan's peak
  within 5% of its prediction on its layer's own input; the scans and the
  attention kernel on those inputs against their plain versions; cache
  bytes, TTFT, tok/s, decode waves and wave times; mamba2's wave compiled
  at budget 0.5 beside the plain one; the requests again with the scans'
  plain versions; float32 served logits at 4 and 3 layers within 1e-3 of
  the forward over the sequence so far (across recurrentgemma's ring
  wrap at position 4096); the serving CLI on both at reduced size;
* the MoE family: qwen2-moe-a2.7b's 24-layer bf16 forward of 8192 tokens
  at full width (60 routed experts padded to 64, top-4, 4 shared),
  unbudgeted and with ``autochunk_budget=0.04``: one MoE block compiled at
  the first layer and replayed for the other 23, its attention on
  ``computed_attention``, its shared expert's SwiGLU on ``chunked_ffn``
  and its routed experts a generic loop; the block's plan, its predicted
  and measured layer-0 peaks (within 5%), both kernels on layer 0's own
  calls against their plain versions, the launches, the aux loss of both
  runs and the assignments layer 0 drops at capacity 640; float32 at 2
  layers (logits and aux within 1e-3 of unbudgeted) and bf16 at 4 layers
  (per block no further from float32 than 1.5 times unbudgeted);
* MoE serving (``[moe-serve]``): qwen2-moe-a2.7b at full width and depth,
  bf16, stacked, through the fixed-slot engine, the ``[moe]`` weights
  freed first: 2 slots, max_len 8320 (rings of the 8192-token window),
  prompts of 8128, 1000 and 2000 tokens with 128, 64 and 32 new (the
  first decodes across position 8192, the third takes the slot the second
  frees); each prefill per block at budget 0.04 under the forward's
  ``moe8192`` tag, ``computed_attention`` and ``chunked_ffn`` launched
  24 x each prefill's plan chunks; each plan's layer-0 peak within 5% of
  its prediction, the assignments dropped at each prefill's capacity, both
  kernels on layer 0's own calls against their plain versions (bf16 and
  f32); cache bytes, TTFT, tok/s, decode waves; the same requests with the
  plain versions swapped in; the wave compiled at budget 0.5 and the plain
  wave against a float32 wave from the same cache (the compiled no further
  than 1.5 times the plain), both wave times beside the wave's bound by
  bytes, and the compiled wave reconfigured inside its bucket; float32 at 2 layers with
  capacity factor 16 (no expert overflows) against ``forward(window=8192)``
  at the first wave, the wrap and the last (1e-3); the serving CLI on the
  reduced model;
* MLA (``[mla]``): deepseek-v3-671b at full width (128 heads, q_lora
  1536, kv_lora 512, 256 experts top-8 with sigmoid routing, 1 shared,
  dense f 18432, vocab 129280), its depth cut to the 3 dense and 2 MoE
  layers plus the MTP head's params (54,616,616,960 B of bf16 weights, the
  list form), the earlier phases' weights freed first.  At S 8192 one
  unchunked block's predicted peak (its summed f32 scores) does not fit
  beside the weights, so the forward runs per block at budget 0.01 (plans
  ``densepre8192`` and ``moe8192``, each compiled at its first layer): the
  plans' loops, the scores a generic loop (no attention kernel computes a
  sum of two products), each first layer's chunked peak within 5% of its
  prediction, the first MoE layer's routing at capacity 320,
  ``chunked_ffn`` launched for every SwiGLU chunk of the plans and no
  attention kernel, ``chunked_ffn`` on layer 0's own calls (f 18432) and
  on the shared expert's call (f 2048) against its plain version, bf16
  and f32, and its time at both shapes; at S 2048 the forward unbudgeted
  and per block against a float32 forward of the same weights (widened
  layer by layer as it runs; per block no further than 1.5 times
  unbudgeted), the MTP head once; float32 at one dense and one MoE layer,
  per block within 1e-3 of unbudgeted (aux within 1e-6);
* training (``[train]``): gpt-paper at full width and depth in bf16,
  trained 30 steps on the synthetic stream (batch 8 x 1024, remat, AdamW
  with float32 moments, lr 1e-3 after 2 warm-up steps): per step the loss,
  ce, lr, CUDA-event ms, tok/s and ``max_memory_allocated``, a finite loss
  that falls by at least 0.5; the trained model's checkpoint reloaded
  bit-equal; ``computed_attention`` and ``chunked_ffn`` refusing an input
  that requires grad, and a ``kernel_dispatch='on'`` compile with trainable
  weights refused; one S 8192 step unbudgeted and one per block at budget
  0.2 (the plan, its predicted forward peak, each step's peak and time);
  float32 gradients at 4 layers, S 2048, through a budget-0.2 block plan
  within 1e-4 of each leaf's largest unbudgeted gradient, and that block's
  inference plan compiled beside it under its own key; the train CLI as a
  subprocess.  No training step launches a kernel: a compile that needs
  gradients dispatches none (the counts are read and must be 0).

Before the SSM and hybrid paths, both scans are held against their plain
versions (mamba2's shape, a length the chunk does not divide, the reduced
config's chunk 16, a shape off every tile edge (p 48, n 64, chunk 100),
and with dt and A drawn as Mamba-2 initialises them mamba2's shape, 1000
rows and batch 2; recurrentgemma's shape, an odd length, batch 2 and a
width that is no multiple of the kernel's 32-channel tile; f32 and bf16
inputs).

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
import gc
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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


_T_START = time.perf_counter()      # reset when main() starts


def lap(name):
    """A ``[phase]`` line: where the script stands when ``name`` is done."""
    print(f"[phase] {name} done {time.perf_counter() - _T_START:.1f}s into the script",
          flush=True)


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


def ragged_case(torch, *, q_lens, kv_lens, H, Kv, hd, ps, max_len, dtype, seed, q_max=None):
    """Random q and a shuffled page pool holding each row's context; q is
    padded to ``q_max`` rows (default: the longest row), as the engine pads
    a prefill step to its chunk."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, q_max = len(q_lens), q_max or max(q_lens)
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
    # the prefix phase's prefill steps at phi3's heads, padded to the 512-row
    # chunk as the engine pads them: a hit's tail of 152 rows whose first
    # key and query sit at position 1000, mid-page and mid-tile, and a
    # miss's last chunk of 128 rows at kv 1152
    "phi3_prefix_hit": dict(q_lens=[152, 0, 0, 0], kv_lens=[1152, 0, 0, 0], q_max=512, H=32,
                            Kv=32, hd=96),
    "phi3_prefix_miss_tail": dict(q_lens=[128, 0, 0, 0], kv_lens=[1152, 0, 0, 0], q_max=512,
                                  H=32, Kv=32, hd=96),
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


# ---------------------------------------------------------------------------
# Observability on the card: the serving window's spans and histograms, the
# cost of recording them, plan accuracy, the trace CLI
# ---------------------------------------------------------------------------

OBS = dict(cost_iters=20_000, cost_limit=0.02, turns=(True, False, False, True),
           decode_prompt=64, decode_new=64, phases=("serve.admit", "serve.prefill_chunk",
                                                    "serve.decode_wave"))


def obs_reset():
    """An enabled, empty tracer and a zeroed registry (counters too: the
    script reads counters only as deltas)."""
    from repro_torch.obs import metrics, tracing

    tracing.set_enabled(True)
    tracing.TRACER.clear()
    metrics.default_registry().reset()


def span_seconds():
    """Host seconds of every recorded span, by name."""
    from repro_torch.obs import tracing

    out = collections.defaultdict(list)
    for sp in tracing.TRACER.spans():
        out[sp.name].append(sp.duration)
    return out


def obs_serving_window(engine, steps, n_reqs, card):
    """Phase 4's timed run as its spans and histograms saw it (the tracer and
    registry reset just before it): one ``serve.step`` span a step, one TTFT
    observation a request, the host seconds of the admit, prefill-chunk and
    decode-wave spans, and the paged engine's plan accuracy."""
    from repro_torch.obs import metrics

    spans = span_seconds()
    hists = metrics.default_registry().snapshot()["histograms"]
    n_ttft = hists["serve_ttft_seconds"]["count"]
    n_step = len(spans["serve.step"])
    check(n_step == steps, f"[obs] {n_step} serve.step spans in {steps} steps")
    check(n_ttft == n_reqs, f"[obs] serve_ttft_seconds counted {n_ttft} of {n_reqs} requests")
    host = {n: sum(spans[n]) for n in OBS["phases"] + ("serve.step",)}
    counts = {n: len(spans[n]) for n in host}
    acc = engine.plan_accuracy()
    print(f"[obs] gpt-paper paged serving: serve.step spans {n_step} = steps {steps};"
          f" serve_ttft_seconds count {n_ttft} = requests {n_reqs}; span counts {counts};"
          f" step latency histogram count {hists['serve_step_latency_seconds']['count']}")
    print(f"[obs] gpt-paper paged plan_accuracy: {acc.to_dict()}; {card}")
    return dict(steps=n_step, ttft_count=n_ttft, span_counts=counts, host_s=host,
                median_step_s=statistics.median(spans["serve.step"]),
                plan_accuracy=acc.to_dict())


def obs_split_line(obs, busy, wall, card):
    """The serving window's host phases beside the device's busy time
    (phase 4b's profiler run; None when the profiler saw no device time)
    and the untraced wall."""
    h = obs["host_s"]
    enq = sum(h[n] for n in OBS["phases"])
    rest = h["serve.step"] - enq
    print(f"[obs] paged serving split, host spans of the timed run: wall {wall:.4f}s; steps"
          f" {h['serve.step']:.4f}s = admit {h['serve.admit']:.4f} + prefill_chunk enqueue"
          f" {h['serve.prefill_chunk']:.4f} + decode_wave enqueue {h['serve.decode_wave']:.4f}"
          f" + the rest {rest:.4f} (sampling's wait for the card, scheduling, retire);"
          f" device busy {'not measured' if busy is None else f'{busy:.4f}s'} (phase 4b,"
          f" torch.profiler); {card}")
    obs["split"] = dict(wall_s=wall, busy_s=busy, enqueue_s=enq, rest_s=rest)


def obs_step_cost(engine, median_step_s, card):
    """The obs calls of one step timed in a host loop (the JAX obs bench's
    sequence: three spans, the step-latency and decode-throughput
    observations, both gauges, two clock reads) over the median
    ``serve.step`` span of the timed run: at most ``OBS["cost_limit"]``."""
    from repro_torch.obs import metrics, tracing

    reg = metrics.default_registry()
    step_latency = reg.histogram("serve_step_latency_seconds", metrics.LATENCY_BUCKETS_S)
    decode_tps = reg.histogram("serve_decode_tok_per_s", metrics.THROUGHPUT_BUCKETS)
    pages, ratio = reg.gauge("serve_pages_in_use"), reg.gauge("serve_cache_hit_ratio")
    rows = engine.max_seqs
    t0 = time.perf_counter()
    for _ in range(OBS["cost_iters"]):
        ts = time.perf_counter()
        with tracing.span("serve.step"):
            with tracing.span("serve.admit"):
                pass
            with tracing.span("serve.decode_wave", prefill_rows=0, decode_rows=rows, q_max=1):
                pass
        dt = time.perf_counter() - ts
        step_latency.observe(dt)
        decode_tps.observe(rows / max(dt, 1e-9))
        pages.set(rows)
        ratio.set(0.5)
    cost = (time.perf_counter() - t0) / OBS["cost_iters"]
    share = cost / median_step_s
    print(f"[obs] obs cost: {cost * 1e6:.2f} us a step (host loop of {OBS['cost_iters']}) over"
          f" the median serve.step {median_step_s * 1e3:.3f} ms = {share:.3%} (limit"
          f" {OBS['cost_limit']:.0%}); {card}")
    check(share <= OBS["cost_limit"], f"[obs] obs cost {share:.3%} of a step")
    return dict(cost_us=cost * 1e6, median_step_ms=median_step_s * 1e3, share=share)


def obs_on_off(torch, engine, cfg, card):
    """Decode-heavy serving with the engine's recording and the tracer on
    and off in turns (on, off, off, on): decode tok/s of each turn, as
    information."""
    import numpy as np

    from repro_torch.obs import tracing
    from repro_torch.serving import Request

    rng = np.random.default_rng(5)
    turns = []
    for i, on in enumerate(OBS["turns"]):
        engine._obs.enabled = on
        tracing.set_enabled(on)
        reqs = [Request(rid=500 + 10 * i + j, max_new_tokens=OBS["decode_new"],
                        prompt=rng.integers(0, cfg.vocab_size, OBS["decode_prompt"]).tolist())
                for j in range(engine.max_seqs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        turns.append((on, sum(len(r.generated) - 1 for r in reqs) / wall))
    engine._obs.enabled = True
    tracing.set_enabled(True)
    on = [t for o, t in turns if o]
    off = [t for o, t in turns if not o]
    print(f"[obs] decode tok/s by turn (obs on/off): "
          + ", ".join(f"{'on' if o else 'off'} {t:.1f}" for o, t in turns)
          + f"; mean on {statistics.mean(on):.1f}, off {statistics.mean(off):.1f}"
          f" (information; {engine.max_seqs} rows, prompts {OBS['decode_prompt']}, new"
          f" {OBS['decode_new']}); {card}")
    return dict(turns=[dict(obs=o, decode_tok_s=t) for o, t in turns])


def obs_trace_export():
    """The tracer's spans exported to a file and summarised by
    ``python -m repro_torch.tools.trace_export FILE --summary`` in a
    subprocess; prints its top rows."""
    from repro_torch.obs import tracing

    with tempfile.TemporaryDirectory(prefix="trace-") as d:
        path = os.path.join(d, "trace.json")
        tracing.TRACER.export_chrome(path)
        proc = subprocess.run([sys.executable, "-m", "repro_torch.tools.trace_export", path,
                               "--summary"], capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    check(proc.returncode == 0, f"[obs] trace_export failed: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    for ln in lines[:10]:
        print(f"[obs] trace_export: {ln}")
    return lines[:10]


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


# The shared-system-prompt scenario of the prefix cache at phi3-mini's full
# width: a 1000-token shared prefix (mid-page at page size 16, so every hit
# copy-on-writes its boundary page), prompts of 1152 tokens, 32 new tokens,
# 8 requests drained one by one, every third (rids 2 and 5) an uncached
# filler whose 74 pages do not fit beside the cached ones, so admission
# spills cached pages to the pinned host arena and the next shared request
# restores them
PREFIX = dict(arch="phi3-mini-3.8b", shared=1000, prompt_len=1152, max_new=32, requests=8,
              max_len=2048, num_pages=120, spill_pages=64, max_seqs=4, check_layers=4)


def prefix_specs(vocab, seed):
    """(prompt, cache_prefix) of each request of the scenario, drawn as the
    serving CLI's ``--shared-prefix`` draws them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, PREFIX["shared"]).tolist()
    specs = []
    for i in range(PREFIX["requests"]):
        if i % 3 == 2:
            specs.append((rng.integers(0, vocab, PREFIX["prompt_len"]).tolist(), False))
        else:
            tail = rng.integers(0, vocab, PREFIX["prompt_len"] - PREFIX["shared"]).tolist()
            specs.append((shared + tail, True))
    return specs


def prefix_engine(PagedServeEngine, Request, cfg, params, *, cache):
    """A paged engine for the scenario, with the prefix cache (and its
    64-page host arena) on or off, warmed by one uncached request."""
    kw = dict(prefix_cache=True, spill_pages=PREFIX["spill_pages"]) if cache else {}
    engine = PagedServeEngine(cfg, params, max_seqs=PREFIX["max_seqs"],
                              max_len=PREFIX["max_len"], page_size=SERVE["page_size"],
                              num_pages=PREFIX["num_pages"], prefill_chunk="auto",
                              autochunk_budget=SERVE["budget"], device="cuda", **kw)
    engine.submit(Request(rid=-1, prompt=[1] * 16, max_new_tokens=2, cache_prefix=False))
    engine.run()
    engine.finished.clear()
    engine.sched_stats.update(dict.fromkeys(engine.sched_stats, 0))
    return engine


def first_token_logits(engine, Request, specs, max_new):
    """Serve ``specs`` one by one; returns the requests and each one's
    logits of its first token (the step that ends its prefill)."""
    last = []
    run_ragged = engine.run_ragged

    def capture(*a):
        out = run_ragged(*a)
        last.append(out[0].float())     # the one running request is row 0
        return out

    engine.run_ragged = capture
    reqs, logits = [], []
    try:
        for i, (prompt, cache_prefix) in enumerate(specs):
            r = Request(rid=i, prompt=prompt, max_new_tokens=max_new, cache_prefix=cache_prefix)
            engine.submit(r)
            while not r.generated:
                engine.step()
            logits.append(last[-1])
            last.clear()
            engine.run()
            reqs.append(r)
    finally:
        engine.run_ragged = run_ragged
    return reqs, logits


def capture_prefill_calls(torch, serving_engine, pool, keep):
    """Put a spy where the engine calls the paged kernel: while ``keep[0]``
    is true it copies the inputs of layer 0's call of every prefill step
    (a row longer than 1) into ``keep[1]``; the kernel runs as usual, so
    the launch count is the engine's own.  Returns the call it replaced."""
    wrapped = serving_engine.paged_attention_blocked

    def spy(q, pages, table, q_lens, kv_lens, *a, **kw):
        if keep[0] and pages.data_ptr() == pool.pages[0].data_ptr() and int(q_lens.max()) > 1:
            keep[1].append(tuple(t.clone() for t in (q, pages, table, q_lens, kv_lens)))
        return wrapped(q, pages, table, q_lens, kv_lens, *a, **kw)

    serving_engine.paged_attention_blocked = spy
    return wrapped


def check_prefix_calls(torch, PA, calls, errs):
    """The kernel against its plain version on the prefix phase's own
    layer-0 prefill inputs (a miss's chunks, a hit's tail starting
    mid-page, a hit over restored pages), as served in bf16 and cast to
    float32, under ``TOL``; padding rows must be zeros."""
    for label, (q, pages, table, q_lens, kv_lens) in calls:
        ql, kl = q_lens.tolist(), kv_lens.tolist()
        for dt_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dt_name)
            args = (q.to(dtype), pages.to(dtype), table, q_lens, kv_lens)
            got = PA.paged_attention_blocked(*args)
            want = PA.paged_attention_blocked_plain(*args)
            torch.cuda.synchronize()
            atol, rtol = TOL[dt_name]
            err, share = real_rows_err(got, want, ql, atol, rtol)
            pad = torch.arange(got.shape[1], device="cuda")[None, :] >= q_lens[:, None]
            print(f"[kernel] paged_attention prefix {label} layer 0 {dt_name}"
                  f" q_max={got.shape[1]} q_lens={ql} kv_lens={kl} (first query at"
                  f" {[k - n for k, n in zip(kl, ql) if n]}): max_abs_err {err:.3e},"
                  f" {share:.3f} of the limit {atol:g} + {rtol:g}|want|")
            check(bool((got[pad] == 0).all()) and bool(torch.isfinite(got).all()),
                  f"prefix {label} {dt_name}: padding rows not zero or non-finite output")
            check(share <= 1.0, f"paged_attention prefix {label} {dt_name} err {err}")
            errs[dt_name] = max(errs.get(dt_name, 0.0), err)


def serve_prefix(torch, PA, stats, M, card):
    """The prefix cache and its host spill tier at phi3-mini's full width
    (32 layers, bf16, hd 96 on the paged kernel), the scenario above: the
    launch count and counters zeroed just before and read just after; 5
    prefix hits (rids 1, 3, 4, 6, 7), a copy-on-write per hit, pages
    restored and no refusal; every cached page that was spilled and then
    restored bit-equal to its bytes before the first filler; the pool's and
    the cache's invariants; nothing left after ``flush()``; the paged
    kernel against its plain version on layer 0's prefill inputs of rid 0
    (a miss), rid 1 (the first hit, from position 1000) and rid 3 (a hit
    over restored pages), kept by a spy as the engine served them.  The same
    requests with the cache off give the TTFT beside it, and at 4 layers in
    float32 the scenario gives equal greedy tokens and first-token logits
    within 1e-3 with the cache on and off."""
    from repro_torch.configs import get_config
    from repro_torch.serving import PagedServeEngine, Request
    from repro_torch.serving import engine as serving_engine

    cfg = get_config(PREFIX["arch"])
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(5), device="cuda")
    specs = prefix_specs(cfg.vocab_size, 5)
    engine = prefix_engine(PagedServeEngine, Request, cfg, params, cache=True)
    pool, cache = engine.prefix_cache.pool, engine.prefix_cache
    check(pool.pages.device.type == "cuda" and pool._host.is_pinned(),
          "the pool is not on the card or its host arena is not pinned")
    # layer 0's prefill inputs of rid 0 (a miss: chunks at kv 512, 1024,
    # 1152), rid 1 (the first hit) and rid 3 (a hit over restored pages)
    keep = [False, []]
    kept, restored_by = {}, {}
    wrapped = capture_prefill_calls(torch, serving_engine, pool, keep)
    before = stats.snapshot()
    torch.cuda.synchronize()
    PA.paged_attention_blocked.launches = 0
    t0 = time.perf_counter()
    reqs, snapshot, seen_spilled = [], {}, set()
    try:
        for i, (prompt, cache_prefix) in enumerate(specs):
            if i == 2:   # before the first filler: each cached page's KV bytes
                snapshot = {id(n): (n, pool.pages[:, n.page].clone())
                            for n in cache._iter_nodes()}
            r = Request(rid=i, prompt=prompt, max_new_tokens=PREFIX["max_new"],
                        cache_prefix=cache_prefix)
            keep[0] = i in (0, 1, 3)
            b = stats.snapshot()
            engine.submit(r)
            engine.run()
            kept[i], keep[1] = keep[1], []
            restored_by[i] = stats.delta(b)["pages_restored"]
            reqs.append(r)
            seen_spilled |= {id(n) for n in cache._iter_nodes() if n.spilled}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = PA.paged_attention_blocked.launches
    finally:
        serving_engine.paged_attention_blocked = wrapped
    d = stats.delta(before)
    steps = engine.sched_stats["steps"]
    toks = sum(len(r.generated) for r in reqs)
    check(all(r.done and len(r.generated) == PREFIX["max_new"] for r in reqs),
          "prefix: not every request finished with max_new tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "prefix: a generated token lies outside the vocabulary")
    check(d["prefix_hits"] == 5, f"prefix: {d['prefix_hits']} prefix hits, not 5")
    check(d["cow_copies"] >= 5, f"prefix: {d['cow_copies']} copy-on-writes, fewer than 5")
    check(d["pages_restored"] > 0, "prefix: no cached page was restored from the host arena")
    check(d["admission_refusals"] == 0, f"prefix: {d['admission_refusals']} admission refusals")
    check(launches == cfg.n_layers * steps > 0,
          f"prefix: paged_attention launched {launches} times in {steps} steps")
    restored = [(n, want) for key, (n, want) in snapshot.items()
                if key in seen_spilled and n.resident]
    check(restored, "prefix: no page of the snapshot was spilled and then restored")
    for n, want in restored:
        check(torch.equal(pool.pages[:, n.page], want),
              f"prefix: the restored page {n.page} differs from its bytes before the spill")
    pool.check_invariants()
    cache.check_invariants()
    n_restored = len(restored)
    n_chunks = -(-PREFIX["prompt_len"] // engine.prefill_chunk)
    check([len(kept[0]), len(kept[1]), len(kept[3])] == [n_chunks, 1, 1] and restored_by[3] > 0,
          f"prefix: layer-0 prefill calls kept {[len(kept[i]) for i in (0, 1, 3)]}, not"
          f" {n_chunks} (the miss) and 1 each (the hits), or rid 3 restored"
          f" {restored_by[3]} pages")
    paged_errs = {}
    check_prefix_calls(torch, PA, [(f"miss rid 0 chunk {j}", c) for j, c in enumerate(kept[0])]
                       + [("hit rid 1", kept[1][0]),
                          (f"hit rid 3 over {restored_by[3]} restored pages", kept[3][0])],
                       paged_errs)
    del kept
    m = engine.metrics()
    pc = m["prefix_cache"]
    print(f"[serve] prefix phi3-mini-3.8b bf16 full width (L={cfg.n_layers} d={cfg.d_model}"
          f" H={cfg.n_heads} hd={cfg.hd}): {len(reqs)} requests of {PREFIX['prompt_len']}"
          f" tokens sharing {PREFIX['shared']}, one by one (rids 2 and 5 uncached fillers),"
          f" {toks} tokens in {wall:.3f}s, {steps} steps; {card}")
    print(f"[serve] prefix counters: prefix_hits={d['prefix_hits']}"
          f" prefix_tokens_reused={d['prefix_tokens_reused']} cow_copies={d['cow_copies']}"
          f" pages_spilled={d['pages_spilled']} pages_restored={d['pages_restored']}"
          f" admission_refusals={d['admission_refusals']}"
          f" spill_retries={engine.sched_stats['spill_retries']}; cache {pc}")
    print(f"[serve] prefix paged_attention launches {launches} = {cfg.n_layers} layers x"
          f" {steps} steps; {n_restored} pages spilled and restored, each bit-equal to its"
          f" bytes before the first filler; host arena {pool.host_capacity} pages pinned"
          f" ({pool._host.numel() * pool._host.element_size()} B)")
    cache.flush()
    check(pool.free_pages == pool.num_pages and pool.spilled_pages == 0
          and pool.alloc_events == pool.free_events,
          f"prefix: after flush free {pool.free_pages} of {pool.num_pages}, spilled"
          f" {pool.spilled_pages}, allocated {pool.alloc_events} freed {pool.free_events}")
    print(f"[serve] prefix after flush: free_pages {pool.free_pages} = num_pages, spilled 0,"
          f" pages allocated {pool.alloc_events} = freed {pool.free_events}")
    del engine, pool, cache, snapshot, restored
    torch.cuda.empty_cache()

    # the same requests with the cache off: each request's TTFT beside the
    # cache's, and which bf16 tokens agree (information)
    off_engine = prefix_engine(PagedServeEngine, Request, cfg, params, cache=False)
    off = []
    for i, (prompt, cache_prefix) in enumerate(specs):
        r = Request(rid=i, prompt=prompt, max_new_tokens=PREFIX["max_new"],
                    cache_prefix=cache_prefix)
        off_engine.submit(r)
        off_engine.run()
        off.append(r)
    torch.cuda.synchronize()
    ttft = {r.rid: (r.ttft_s, o.ttft_s) for r, o in zip(reqs, off) if r.rid % 3 != 2}
    for rid, (on_s, off_s) in ttft.items():
        print(f"[serve] prefix TTFT rid {rid}: cache on {on_s * 1e3:.2f} ms, off"
              f" {off_s * 1e3:.2f} ms")
    same = sum(a == b for r, o in zip(reqs, off) for a, b in zip(r.generated, o.generated))
    print(f"[serve] prefix bf16 tokens equal with the cache on and off: {same} of {toks};"
          f" {card}")
    del off_engine, params
    torch.cuda.empty_cache()

    # float32 at 4 layers: the cache changes no token and moves no logit
    cfg32 = cfg.with_(dtype="float32", n_layers=PREFIX["check_layers"])
    params32 = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(6),
                             device="cuda")
    runs = {}
    for on in (True, False):
        e = prefix_engine(PagedServeEngine, Request, cfg32, params32, cache=on)
        runs[on] = first_token_logits(e, Request, specs, PREFIX["max_new"])
        del e
    tokens_equal = all(a.generated == b.generated for a, b in zip(runs[True][0], runs[False][0]))
    err = max(float((a - b).abs().max()) for a, b in zip(runs[True][1], runs[False][1]))
    print(f"[serve] prefix fp32 L={cfg32.n_layers}: greedy tokens with the cache on and off"
          f" {'equal' if tokens_equal else 'DIFFER'}, first-token logits max_abs_err"
          f" {err:.3e} (limit 1e-3)")
    check(tokens_equal, "prefix: fp32 greedy tokens differ with the cache on and off")
    check(err <= 1e-3, f"prefix: fp32 first-token logits differ by {err}")
    del params32, runs
    torch.cuda.empty_cache()
    return dict(launches=launches, steps=steps, tokens=toks, wall_s=wall,
                counters={k: d[k] for k in ("prefix_hits", "prefix_tokens_reused",
                                            "cow_copies", "pages_spilled", "pages_restored",
                                            "admission_refusals")},
                restored_pages_bit_equal=n_restored, paged_errs=paged_errs,
                ttft_on_off_s=ttft, bf16_tokens_equal=same, fp32_logits_err=err)


def serve_prefix_cli(torch, stats):
    """The serving CLI's shared-prefix scenario on the card (gpt-paper, full
    width): its ``[serve] prefix:`` line, 5 hits and restored pages."""
    import contextlib
    import io

    from repro_torch.launch import serve

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "gpt-paper", "--paged", "--device", "cuda", "--prefix-cache",
                    "--spill-pages", str(PREFIX["spill_pages"]),
                    "--shared-prefix", str(PREFIX["shared"]),
                    "--prompt-len", str(PREFIX["prompt_len"]),
                    "--max-new", str(PREFIX["max_new"]), "--requests", str(PREFIX["requests"]),
                    "--max-len", str(PREFIX["max_len"]),
                    "--num-pages", str(PREFIX["num_pages"]),
                    "--max-seqs", str(PREFIX["max_seqs"])])
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[serve] prefix:")]
    check(len(lines) == 1, "the serving CLI printed no [serve] prefix: line")
    print(f"[serve] CLI gpt-paper --shared-prefix {PREFIX['shared']}: {lines[0][len('[serve] '):]}")
    got = dict(re.findall(r"(\w+)=(\d+)", lines[0]))
    check(int(got["prefix_hits"]) == 5 and int(got["pages_restored"]) > 0,
          f"the serving CLI's prefix counters: {got}")
    torch.cuda.empty_cache()
    return {k: int(v) for k, v in got.items()}


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
    # the spy holds the engine: put the method back, so that no reference
    # cycle keeps the engine's pool on the card after it is deleted
    del engine.run_ragged
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


def compile_forward(torch, cfg, model, batch, *, mask_mode, cache=None):
    """Trace, search and compile the forward (its plan stored in ``cache``,
    a ``PlanCache``, when given); returns (compiled, planned, host seconds
    of each stage)."""
    from repro_torch.core import ChunkConfig, autochunk
    from repro_torch.models import model as M

    cf = autochunk(M.logits_fn(model), ChunkConfig(
        budget_ratio=COMPILE["budget"], max_stages=COMPILE["max_stages"],
        mask_mode=mask_mode), cache=cache)
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


def plan_forward_on_meta(cfg, mask_mode, seq_len, cache_dir):
    """The ``[compile]`` cell's forward of ``cfg`` at ``seq_len`` under
    ``mask_mode`` (budget 0.2), traced and searched on ``meta`` into the
    on-disk plan cache ``cache_dir``, as the precompile CLI does; ``main``
    runs it in a child process at low priority beside the phases before
    ``[compile]``.  Returns (stages, host seconds of the trace and
    search)."""
    os.nice(10)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import ChunkConfig, autochunk
    from repro_torch.models import model as M

    model = M.init_params(cfg, device="meta")
    batch = {"tokens": torch.empty((1, seq_len), dtype=torch.int64, device="meta")}
    t0 = time.perf_counter()
    cf = autochunk(M.logits_fn(model), ChunkConfig(
        budget_ratio=COMPILE["budget"], max_stages=COMPILE["max_stages"],
        mask_mode=mask_mode), cache=cache_dir)
    planned = cf.trace(dict(model.named_parameters()), batch).search()
    return len(planned.plan.stages), time.perf_counter() - t0


def check_forward_fp32(torch, M, cfg, keep, planned_on_meta, cache_dir,
                       modes=("auto", "bool")):
    """Chunked against unchunked logits in float32, at the full length, for
    each mask mode: one float32 model and its unchunked logits, each mode's
    compile held against them.  At 2048 tokens the unembed's 413 MB of f32
    logits outweigh each layer's attention (12 S^2 f32 grows past 50432 S
    at S ~ 4200), so the search chunks no attention site there and the
    kernels would go unchecked.  Each mode's plan was searched on ``meta``
    by a child process (``planned_on_meta``: mode -> a future of
    :func:`plan_forward_on_meta`) into ``cache_dir``; the compile here
    replays it (a plan-cache hit, no search).  The plan cache is kept with
    the model in ``keep`` for the ``[cache]`` phase's float32 bucket
    executable, whose plan at S 8192 is the "auto" one.  Returns the error
    per mode."""
    import numpy as np
    from repro_torch.core import stats
    from repro_torch.core.plan import PlanCache

    cfg32 = cfg.with_(dtype="float32")
    plans = PlanCache(cache_dir)
    S = COMPILE["seq_len"]
    model = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(4), device="cuda")
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)), device="cuda")}
    params = dict(model.named_parameters())
    with torch.no_grad():
        y0 = M.logits_fn(model)(params, batch)[..., :cfg.vocab_size]
    errs = {}
    for mode in modes:
        t0 = time.perf_counter()
        stages, search_s = planned_on_meta[mode].result()
        waited = time.perf_counter() - t0
        before = stats.snapshot()
        compiled, planned, seconds = compile_forward(torch, cfg32, model, batch, mask_mode=mode,
                                                     cache=plans)
        d = stats.delta(before)
        check(d["plan_cache_hits"] == 1 and d["search_passes"] == 0
              and len(planned.plan.stages) == stages,
              f"fp32 {mode}: the meta plan did not replay: {d}")
        n_dispatched = len(dispatched_loops(planned))
        check(n_dispatched == cfg.n_layers, f"fp32: {n_dispatched} attention sites dispatched")
        with torch.no_grad():
            y1 = compiled(params, batch)
        errs[mode] = err = float((y1[..., :cfg.vocab_size] - y0).abs().max())
        print(f"[forward] {mode}: fp32 S={S}, {len(compiled.result.plan)} stages (searched on"
              f" meta by a child process in {search_s:.2f} host seconds beside the earlier"
              f" phases, {waited:.2f}s waited for it here; replayed here in {sum(seconds):.2f}"
              f" host seconds, 0 search passes), {n_dispatched} attention sites dispatched:"
              f" chunked vs unchunked logits max_abs_err {err:.3e} (limit 1e-3)")
        check(err <= 1e-3, f"fp32 chunked logits differ by {err}")
        del compiled, planned, y1
    keep.update(model32=model, plans32=plans)
    return errs


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
    as a subprocess; returns (plans on disk, host seconds, its output).
    ``main`` starts it on a thread after the build, so its host seconds
    overlap the phases before ``[cache]``."""
    cmd = [sys.executable, "-m", "repro_torch.tools.precompile", "--configs", "gpt-paper",
           "--full", "--seq-lens", str(COMPILE["seq_len"]), "--budgets", str(COMPILE["budget"]),
           "--max-stages", str(COMPILE["max_stages"]), "--cache-dir", str(cache_dir)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=CACHE["precompile_timeout"])
    seconds = time.perf_counter() - t0
    lines = (proc.stdout + proc.stderr).splitlines()
    return len(list(Path(cache_dir).glob("*.json"))), seconds, lines, proc.returncode


def run_cache_phase(torch, CA, stats, M, cfg, cold, card, precompiled, cache_dir):
    """Warm replay of the precompiled full-width plan from disk against the
    ``[compile]`` phase's cold compile (kept in ``cold``), then the canonical
    bucket executable at S 8192, 6000 and 7000, and in float32 at S 6000
    from the float32 check's plan (``cold["plans32"]``).  The precompile
    subprocess (``precompiled``, a future of :func:`precompile_plans`)
    wrote ``cache_dir``.  Kernel counts zeroed just before each drive and
    read just after."""
    import numpy as np
    from repro_torch.core import ChunkConfig, autochunk

    S = COMPILE["seq_len"]
    knobs = dict(budget_ratio=COMPILE["budget"], max_stages=COMPILE["max_stages"])
    model, batch = cold["model"], cold["batch"]
    params = dict(model.named_parameters())
    t0 = time.perf_counter()
    n_plans, pre_s, lines, rc = precompiled.result()
    waited = time.perf_counter() - t0
    for line in lines:
        print(f"[cache] precompile: {line}")
    check(rc == 0, f"precompile exited {rc}")
    check(n_plans == 1, f"{n_plans} plans precompiled, want 1")
    print(f"[cache] precompile gpt-paper S={S} budget {COMPILE['budget']} on meta:"
          f" {n_plans} plan in {pre_s:.2f} host seconds (a subprocess, its start-up"
          f" included, started after the build beside the phases before this one;"
          f" {waited:.2f}s waited for it here)")

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
    # the float32 check's model, its S 8192 "auto" plan replayed from the
    # float32 check's plan cache (the same program: no second search)
    model32 = cold["model32"]
    params32 = dict(model32.named_parameters())
    n = CACHE["bucket_lens"][0]
    tok = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (1, n)),
                       device="cuda")
    cf32 = autochunk(M.logits_fn(model32), ChunkConfig(canonical_bucket_exec=True, **knobs),
                     cache=cold["plans32"])
    before = stats.snapshot()
    with torch.no_grad():
        y1 = cf32(params32, {"tokens": tok})
        d32 = stats.delta(before)
        y0 = M.logits_fn(model32)(params32, {"tokens": tok})
    err = float((y1[..., :cfg.vocab_size] - y0[..., :cfg.vocab_size]).abs().max())
    bucket = cf32.stats()
    print(f"[cache] fp32 S={n} through the bucket executable compiled at S={S}"
          f" ({bucket['bucket_exec_compiles']} compile from the float32 check's plan:"
          f" plan_cache_hits {d32['plan_cache_hits']}, search passes {d32['search_passes']};"
          f" {bucket['padded_shapes']} padded shape): logits against the unchunked forward at"
          f" S={n} max_abs_err {err:.3e} (limit 1e-3)")
    check(bucket["bucket_exec_compiles"] == 1 and bucket["padded_shapes"] == 1,
          f"fp32 bucket executable: {bucket}")
    check(d32["plan_cache_hits"] == 1 and d32["search_passes"] == 0,
          f"fp32 bucket executable searched again: {d32}")
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
        # the attention loop slices query rows (16 x 512) or heads (8 x 4)
        by = "rows" if attn[0] * attn[1] >= S else "heads"
        print(f"[forward] phi3-mini-3.8b per-block {dt_name} L={L} S={S} budget"
              f" {PHI3['budget']}: {secs:.2f}s with the block compile, {ms1:.2f} ms replayed;"
              f" {len(r.plan)} stages; dispatch hits {d['kernel_dispatch_hits']}, misses"
              f" {d['kernel_dispatch_misses']}; computed_attention launches {n_attn} = {L} layers"
              f" x {attn[1]} chunks of {attn[0]} {by} (hd {c.hd}), chunked_ffn launches {n_ffn} ="
              f" {L} layers x {swiglu[1]} chunks of {swiglu[0]} rows; layer 0 activation peak"
              f" unchunked {bpeak0} B (predicted {r.baseline_peak} B), chunked {bpeak1} B"
              f" (predicted {r.final_peak} B, {bpeak1 / r.final_peak:.4f}x; budget"
              f" {r.budget_bytes} B); per-block vs"
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
        # ROADMAP C-5: the f32 plan ended above its budget before K and V
        # were copied once before the attention loop
        check(r.final_peak <= r.budget_bytes,
              f"phi3 {dt_name}: predicted block peak {r.final_peak} B above the budget"
              f" {r.budget_bytes} B")
        if dt_name == "float32":
            check(err <= 1e-3, f"phi3 fp32 per-block logits differ by {err}")
        out[dt_name] = dict(launches=n_ffn, attention_launches=n_attn, swiglu_chunk=swiglu[0],
                            attention_chunk=attn[0], attention_chunks=attn[1],
                            attention_by=by,
                            stages=len(r.plan), logits_err=err, seconds=secs, ms=ms1,
                            pred_block0=r.baseline_peak, pred_block1=r.final_peak,
                            budget_bytes=r.budget_bytes,
                            block_peak0=bpeak0, block_peak1=bpeak1)
        del model, cf, p0, h0
        M._AC_CACHE.clear()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The fixed-slot engine: phi3-mini-3.8b served past its 8192-token window
# ---------------------------------------------------------------------------

SLOT = dict(arch="phi3-mini-3.8b", max_batch=2, max_len=8320,
            # the largest of 0.1, 0.05 and 0.03 whose block plan at S 8128
            # dispatches both the attention and the SwiGLU site (a CPU plan
            # on meta for the card: 0.1 and 0.05 chunk the attention over
            # heads and leave the MLP whole)
            budget=0.03,
            # two prompts decoding across position 8192 (the ring's first
            # wrap at wave 64), a third admitted into a freed slot
            prompts=(8128, 8128, 1000), max_new=(128, 128, 32),
            fp32_layers=4, wave_budget=0.5, second_max_len=9000, wave_reps=10,
            cli=["--arch", "gpt-paper", "--max-batch", "4", "--max-len", "2048",
                 "--prompt-len", "1024", "--max-new", "32", "--autochunk", "0.5",
                 "--second-max-len", "1500", "--device", "cuda"])


def make_requests(Request, vocab, seed, prompts, max_new):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).tolist(), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(prompts, max_new))]


def slot_requests(Request, vocab, seed):
    return make_requests(Request, vocab, seed, SLOT["prompts"], SLOT["max_new"])


def swap_plain(CA, CF):
    """Put the plain versions where dispatched loops call the kernels;
    returns the function that puts the kernels back."""
    saved = (CA.computed_attention, CA.masked_attention, CF.chunked_ffn)
    CA.computed_attention = CA.computed_attention_plain
    CA.masked_attention = CA.masked_attention_plain
    CF.chunked_ffn = lambda x, wg, wu, wd, **kw: CF.chunked_ffn_plain(x, wg, wu, wd)

    def restore():
        CA.computed_attention, CA.masked_attention, CF.chunked_ffn = saved
    return restore


def slot_block_plans(torch, CA, M, cfg, model, prompts, errs):
    """The per-block plan the prefills ran at each prompt length (``prompts``:
    length -> a prompt the engine served): stages, loops, layer 0's
    predicted against measured peak (within 5%), and the attention kernel
    held against its plain version on layer 0's own inputs of that prompt
    (``TOL``)."""
    (cf,) = M._AC_CACHE.values()
    p0 = M._index_tree(model["blocks"], 0)
    out = {}
    for S, prompt in prompts.items():
        tokens = torch.tensor([prompt], device="cuda")
        h0 = M.embed_inputs(cfg, model, {"tokens": tokens})[0]
        planned = cf.trace(p0, h0).search()
        loops = block_loops(planned)
        with torch.no_grad():
            cf(p0, h0)
            _, peak, ms = measure_forward(torch, cf, (p0, h0))
        pred = planned.final_peak
        comp = []
        masked = capture_calls(torch, CA, "masked_attention", lambda: comp.extend(
            capture_calls(torch, CA, "computed_attention", lambda: cf(p0, h0))))
        calls = {"computed_attention": comp, "masked_attention": masked}
        n_calls = {k: len(v) for k, v in calls.items()}
        for kname, kcalls in calls.items():
            plain = getattr(CA, f"{kname}_plain")
            kernel = getattr(CA, kname)
            for i, (args, kw) in enumerate(kcalls):
                dt_name = str(args[0].dtype).removeprefix("torch.")
                err = hold(torch, kname, f"slot prefill S={S} layer 0 call {i} {dt_name}"
                           f" Sq={args[0].shape[1]} Skv={args[1].shape[1]} H={args[0].shape[0]}"
                           f" Kv={args[1].shape[0]} hd={args[0].shape[2]}",
                           lambda: kernel(*args, **kw), lambda: plain(*args, **kw),
                           TOL[dt_name])
                errs[(kname, dt_name)] = max(errs.get((kname, dt_name), 0.0), err)
        attn, swiglu = loops.get("attention", (0, 0)), loops.get("swiglu", (0, 0))
        print(f"[slot] block plan S={S} budget {SLOT['budget']}: {len(planned.plan.stages)}"
              f" stages, dispatched loops {loops}; layer 0 activation peak {peak} B against"
              f" predicted {pred} B ({peak / pred:.4f}x), budget {planned.budget_bytes} B;"
              f" {ms:.2f} ms; layer-0 kernel calls {n_calls}")
        check(abs(peak - pred) <= 0.05 * pred,
              f"slot block S={S}: peak {peak} B not within 5% of the predicted {pred} B")
        check(sum(n_calls.values()) == attn[1] > 0,
              f"slot block S={S}: attention calls {n_calls}, plan {attn}")
        out[S] = dict(stages=len(planned.plan.stages), attention=list(attn),
                      swiglu=list(swiglu), pred_peak=pred, peak=peak, ms=ms,
                      budget_bytes=planned.budget_bytes, kernel_calls=n_calls)
        del h0, calls
    return out


def served_fp32_logits(torch, M, ServeEngine, Request, cfg, run, seed, label, rows, card,
                       why=""):
    """``cfg`` (float32, cut in depth) served as ``run`` serves its model,
    the prefill per block under ``run["budget"]``: rid 0's logits at the
    first decode wave, the wave that writes position ``cfg.sliding_window``
    (the ring's first wrap) and the last, against the unchunked
    ``forward(..., window=cfg.sliding_window)`` over its sequence so far
    (limit 1e-3; ``why`` follows the result on its line).  Then the wave
    compiled at ``run["wave_budget"]`` against the plain one on the same
    cache, next tokens and positions (float32 ``TOL``): ``rows`` are the
    requests the two slots hold when the run ends."""
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    M._AC_CACHE.clear()
    engine = ServeEngine(cfg.with_(autochunk_budget=run["budget"]), model,
                         max_batch=run["max_batch"], max_len=run["max_len"], device="cuda")
    S0, n0 = run["prompts"][0], run["max_new"][0]
    waves = {"first": 0, "wrap": cfg.sliding_window - S0, "last": n0 - 2}
    kept = {}
    wave = engine._decode_wave

    def spy(cache, toks, pos):
        logits = wave(cache, toks, pos)
        w = engine.n_decode_steps
        for name, at in waves.items():
            if w == at:
                kept[name] = (int(pos[0]), logits[0].float().clone())
        return logits

    engine._decode_wave = spy
    reqs = make_requests(Request, cfg.vocab_size, seed, run["prompts"], run["max_new"])
    for r in reqs:
        engine.submit(r)
    engine.run()
    engine._decode_wave = wave      # the spy holds the engine: no reference cycle
    check(all(r.done and len(r.generated) == m for r, m in zip(reqs, run["max_new"])),
          f"fp32 {label} serving: a request did not finish")
    # the wave compiled at the run's wave budget against the plain one, on
    # the same cache, tokens and positions (float32 limit of TOL)
    e2 = ServeEngine(cfg, model, max_batch=run["max_batch"], max_len=run["max_len"],
                     autochunk_budget=run["wave_budget"], device="cuda")
    for full, mine in zip(torch.utils._pytree.tree_leaves(e2.cache),
                          torch.utils._pytree.tree_leaves(engine.cache)):
        full.copy_(mine)
    last = [reqs[i] for i in rows]
    toks_w = torch.tensor([r.generated[-1] for r in last], device="cuda")
    pos_w = torch.tensor([len(r.prompt) + len(r.generated) for r in last], device="cuda")
    with torch.no_grad():
        want = wave(engine.cache, toks_w, pos_w)[:, :cfg.vocab_size]
        got = e2._decode_wave(e2.cache, toks_w, pos_w)[:, :cfg.vocab_size]
    wave_err = compare(torch, "decode wave", f"fp32 L={cfg.n_layers} compiled (budget"
                       f" {run['wave_budget']}, {len(e2.autochunk_result.plan)} stages)"
                       " against plain", got, want, TOL["float32"])
    leaves = zip(torch.utils._pytree.tree_leaves(e2.cache),
                 torch.utils._pytree.tree_leaves(engine.cache))
    cache_err = max(float((a - b).abs().max()) for a, b in leaves)
    print(f"[{label}] fp32 caches after the two waves: max_abs_err {cache_err:.3e} (limit 1e-4)")
    check(cache_err <= 1e-4, f"the compiled wave wrote another cache: {cache_err}")
    del e2
    check(kept["wrap"][0] == cfg.sliding_window, f"the wrap wave was at {kept['wrap'][0]}")
    seq = reqs[0].prompt + reqs[0].generated
    errs = {}
    with torch.no_grad():
        for name, (pos, got) in kept.items():
            toks = torch.tensor([seq[:pos + 1]], device="cuda")
            want = M.forward(cfg, model, {"tokens": toks}, window=cfg.sliding_window)[0][0, -1]
            errs[name] = float((got[:cfg.vocab_size] - want[:cfg.vocab_size].float())
                               .abs().max())
            del want
            torch.cuda.empty_cache()
    print(f"[{label}] fp32 L={cfg.n_layers}: rid 0 decode logits against forward(window="
          f"{cfg.sliding_window}) over the sequence so far: "
          + ", ".join(f"{k} wave (position {kept[k][0]}) {v:.3e}" for k, v in errs.items())
          + f" (limit 1e-3){why}; {card}")
    check(max(errs.values()) <= 1e-3, f"fp32 {label} logits differ from the forward: {errs}")
    M._AC_CACHE.clear()
    del engine, model
    torch.cuda.empty_cache()
    return ({f"{k}_position": kept[k][0] for k in kept} | {f"{k}_err": v for k, v in errs.items()}
            | {"compiled_wave_err": wave_err, "compiled_wave_cache_err": cache_err})


def slot_cli(torch):
    """``serve.main`` without ``--paged`` on the card (gpt-paper, full width):
    the fixed-slot engine with its wave compiled, then reconfigured inside
    the same bucket: ``bucket_exec_hits=1 new_traces=0 new_searches=0
    new_wave_compiles=0``; with ``--metrics-out``, ``--trace-out`` and
    ``--prom-out``, whose three files must exist and parse ([obs])."""
    import contextlib
    import io

    from repro_torch.launch import serve
    from repro_torch.tools import trace_export

    out = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="obs-cli-") as d:
        files = {flag: os.path.join(d, name) for flag, name in (
            ("--metrics-out", "metrics.json"), ("--trace-out", "trace.json"),
            ("--prom-out", "metrics.prom"))}
        with contextlib.redirect_stdout(out):
            serve.main(SLOT["cli"] + [a for kv in files.items() for a in kv])
        check(all(os.path.exists(f) for f in files.values()), "[obs] CLI: an output is missing")
        with open(files["--metrics-out"]) as f:
            doc = json.load(f)
        n_spans = sum(1 for e in trace_export.load_events(files["--trace-out"])
                      if e.get("ph") == "X")
        with open(files["--prom-out"]) as f:
            prom = f.read()
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[serve]")]
    for ln in lines:
        print(f"[slot] CLI gpt-paper: {ln}")
    want = "[serve] second run: bucket_exec_hits=1 new_traces=0 new_searches=0 new_wave_compiles=0"
    check(want in lines, "the serving CLI's second run reused no warm wave")
    ttft = doc["metrics"]["histograms"]["serve_ttft_seconds"]["count"]
    print(f"[obs] CLI gpt-paper files: metrics JSON keys {sorted(doc)}, serve_ttft_seconds"
          f" count {ttft}; trace {n_spans} spans; Prometheus text"
          f" {prom.count(chr(10))} lines")
    check(set(doc) == {"counters", "metrics", "plan_accuracy"} and ttft > 0 and n_spans > 0
          and "# TYPE serve_ttft_seconds histogram" in prom,
          "[obs] CLI: the metrics, trace or Prometheus file does not parse as written")
    torch.cuda.empty_cache()
    return [ln for ln in lines if "requests" in ln or "second run:" in ln
            or "plan_accuracy" in ln]


SLOT_WAVE_SPANS = ("compile.trace", "compile.estimate", "compile.search", "compile.select",
                   "compile.emit", "serve.compile")


def obs_slot_wave(torch, engine, Request, prompt, wave_args, card):
    """[obs] on the slot phase's compiled wave (budget 0.5, the tracer reset
    just before the engine was built): its compile spans, then one request
    served through ``step()``, whose wave is the engine's device measurement;
    its ``plan_accuracy()`` (source ``device``) must lie within 1% of this
    script's own ``max_memory_allocated`` delta around one compiled wave
    (``measure_forward``, as the block peaks are measured)."""
    names = set(span_seconds())
    missing = [n for n in SLOT_WAVE_SPANS if n not in names]
    check(not missing, f"[obs] slot wave compile: no spans {missing} (got {sorted(names)})")
    req = Request(rid=300, prompt=prompt, max_new_tokens=2)
    engine.submit(req)
    engine.run()
    check(req.done and len(req.generated) == 2, "[obs] slot: the measured request did not finish")
    acc = engine.plan_accuracy()
    with torch.no_grad():
        _, peak, _ = measure_forward(torch, engine._decode_wave, wave_args)
    ratio = acc.measured_bytes / peak
    print(f"[obs] slot compiled wave spans: {sorted(names)}")
    print(f"[obs] slot compiled wave plan_accuracy: predicted {acc.predicted_bytes} B, measured"
          f" {acc.measured_bytes} B (source {acc.source}; interpret watermark"
          f" {acc.extra.get('interpret_measured_bytes')} B), error {acc.error_pct:.2f}%; this"
          f" script's max_memory_allocated delta around one compiled wave {peak} B (engine /"
          f" script {ratio:.4f}, limit within 1%); {card}")
    check(acc.source == "device" and abs(acc.measured_bytes - peak) <= 0.01 * peak,
          f"[obs] slot wave: device plan_accuracy {acc.to_dict()} against {peak} B")
    return dict(spans=sorted(names), plan_accuracy=acc.to_dict(), script_peak=peak)


def run_slot_phase(torch, CA, CF, stats, M, flush, card):
    """The fixed-slot engine at phi3-mini's full width and depth, bf16, its
    prefill per block under SLOT's budget (attention on ``computed_attention``
    or, for a head-chunked plan, ``masked_attention``; SwiGLU on
    ``chunked_ffn``): two 8128-token prompts decoding past position 8192
    and a third request in a freed slot, with the launch counts zeroed just
    before serving and read just after; the block plans and peaks; the
    kernels on layer 0's own inputs; the plain versions swapped in; the
    compiled wave against the plain one and reconfigured inside its bucket;
    fp32 logits at 4 layers against the windowed forward; the CLI."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Request, ServeEngine

    cfg = get_config(SLOT["arch"])                       # bf16, 32 layers, window 8192
    cfg_ac = cfg.with_(autochunk_budget=SLOT["budget"])
    L = cfg.n_layers
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(13), device="cuda")
    M._AC_CACHE.clear()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg_ac, model, max_batch=SLOT["max_batch"], max_len=SLOT["max_len"],
                         device="cuda")
    build_s = time.perf_counter() - t0
    width = M.cache_width(cfg, engine.exec_len)
    cache_bytes = sum(t.numel() * t.element_size() for t in
                      torch.utils._pytree.tree_leaves(engine.cache))
    print(f"[slot] phi3-mini-3.8b engine built in {build_s:.2f}s: {SLOT['max_batch']} slots,"
          f" max_len {SLOT['max_len']}, exec_len {engine.exec_len}, ring width {width},"
          f" cache {cache_bytes} B")
    check(engine.exec_len == 16384 and width == cfg.sliding_window
          and cache_bytes == SLOT["max_batch"] * L * 2 * width * cfg.n_kv_heads * cfg.hd * 2,
          f"slot cache: exec_len {engine.exec_len}, width {width}, {cache_bytes} B")

    reqs = slot_requests(Request, cfg.vocab_size, 13)
    torch.cuda.synchronize()
    CA.computed_attention.launches = CA.masked_attention.launches = 0
    CF.chunked_ffn.launches = 0
    before = stats.snapshot()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_comp, n_mask = CA.computed_attention.launches, CA.masked_attention.launches
    n_ffn = CF.chunked_ffn.launches
    d = stats.delta(before)
    toks = sum(len(r.generated) for r in reqs)
    check(all(r.done and len(r.generated) == m for r, m in zip(reqs, SLOT["max_new"])),
          "slot serving: a request did not finish with its new tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "slot serving: a token outside the vocabulary")
    waves = engine.n_decode_steps
    check(waves == SLOT["max_new"][0] - 1 + SLOT["max_new"][2] - 1,
          f"slot serving: {waves} decode waves")
    ttft = {r.rid: r.ttft_s for r in reqs}
    print(f"[slot] served {len(reqs)} requests (prompts {SLOT['prompts']}, new"
          f" {SLOT['max_new']}) on {SLOT['max_batch']} slots: {toks} tokens in {wall:.3f}s ="
          f" {toks / wall:.1f} tok/s, {waves} decode waves; TTFT"
          f" {', '.join(f'rid {k} {v:.3f}s' for k, v in ttft.items())}; block compiles"
          f" {d['search_passes']} searches; {card}")

    # layer 0's own inputs: the prompts the engine served (rid 0, rid 2)
    errs = {}
    first = {}
    for r in reqs:
        first.setdefault(len(r.prompt), r.prompt)
    plans = slot_block_plans(torch, CA, M, cfg, model, first, errs)
    want_attn = sum(L * plans[len(r.prompt)]["attention"][1] for r in reqs)
    want_ffn = sum(L * plans[len(r.prompt)]["swiglu"][1] for r in reqs)
    print(f"[slot] launches while serving: computed_attention {n_comp}, masked_attention"
          f" {n_mask} (together {n_comp + n_mask} = sum over the 3 prefills of {L} layers x"
          f" attention chunks = {want_attn}), chunked_ffn {n_ffn} (= {want_ffn})")
    check(n_comp + n_mask == want_attn > 0 and n_ffn == want_ffn > 0,
          f"slot launches: attention {n_comp}+{n_mask} want {want_attn}, ffn {n_ffn} want"
          f" {want_ffn}")

    # the same requests with the plain versions swapped in (information)
    plain_reqs = [Request(rid=100 + r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                  for r in reqs]
    restore = swap_plain(CA, CF)
    try:
        for r in plain_reqs:
            engine.submit(r)
        engine.run()
    finally:
        restore()
    same = sum(a == b for r, rp in zip(reqs, plain_reqs) for a, b in zip(r.generated, rp.generated))
    print(f"[slot] the same requests with the plain versions swapped in: {same} of {toks}"
          f" tokens equal to the kernels'")

    # the compiled wave (budget 0.5) against the plain one, on the same
    # cache, tokens and positions; then reconfigured inside its bucket
    obs_reset()             # [obs]: the wave compile's spans
    before = stats.snapshot()
    t0 = time.perf_counter()
    e2 = ServeEngine(cfg_ac, model, max_batch=SLOT["max_batch"], max_len=SLOT["max_len"],
                     autochunk_budget=SLOT["wave_budget"], device="cuda")
    wave_build = time.perf_counter() - t0
    dw = stats.delta(before)
    res = e2.autochunk_result
    for full, mine in zip(torch.utils._pytree.tree_leaves(e2.cache),
                          torch.utils._pytree.tree_leaves(engine.cache)):
        full.copy_(mine)
    # slot 0 holds rid 2's cache (admitted first into the freed slots),
    # slot 1 rid 1's: each row's next token and position
    toks_w = torch.tensor([plain_reqs[2].generated[-1], plain_reqs[1].generated[-1]],
                          device="cuda")
    pos_w = torch.tensor([len(plain_reqs[2].prompt) + len(plain_reqs[2].generated),
                          len(plain_reqs[1].prompt) + len(plain_reqs[1].generated)],
                         device="cuda")
    print(f"[slot] compiled wave: built in {wave_build:.2f}s ({dw['trace_calls']} trace,"
          f" {dw['search_passes']} search passes), {len(res.plan)} stages, predicted peak"
          f" {res.baseline_peak} -> {res.final_peak} B (budget {res.budget_bytes} B);"
          f" dispatch hits {dw['kernel_dispatch_hits']}, misses {dw['kernel_dispatch_misses']}")
    # both bf16 waves against the plain wave in float32 from the same cache
    # (the weights and cache widened): the compiled wave's products sum in
    # other orders, and each layer rounds its output to bf16, so the two
    # bf16 waves part by a few bf16 steps over 32 layers; the compiled one
    # must be no further from float32 than 1.5x the plain one (the
    # per-block rule)
    with torch.no_grad():
        params32 = {k: v.float() for k, v in model.named_parameters()}
        cache32 = torch.utils._pytree.tree_map(lambda t: t.float(), e2.cache)
        lg_ref = M.decode_fn(model)(params32, cache32, toks_w, pos_w)[:, :cfg.vocab_size]
        del params32, cache32
        torch.cuda.empty_cache()
        CA.computed_attention.launches = CA.masked_attention.launches = 0
        lg_plain = engine._decode_wave(engine.cache, toks_w, pos_w)[:, :cfg.vocab_size]
        lg_comp = e2._decode_wave(e2.cache, toks_w, pos_w)[:, :cfg.vocab_size]
    wave_launches = {"computed_attention": CA.computed_attention.launches,
                     "masked_attention": CA.masked_attention.launches}
    wave_err = float((lg_comp.float() - lg_plain.float()).abs().max())
    d_comp = float((lg_comp.float() - lg_ref).abs().max())
    d_plain = float((lg_plain.float() - lg_ref).abs().max())
    print(f"[slot] first compiled wave against the plain one, bf16 logits: max_abs_err"
          f" {wave_err:.3e} (max|plain| {float(lg_plain.float().abs().max()):.3f}); from the"
          f" float32 wave: compiled {d_comp:.3e}, plain {d_plain:.3e} (limit 1.5x the plain's);"
          f" attention kernel launches in the waves {wave_launches}")
    check(bool(torch.isfinite(lg_comp).all()) and d_comp <= 1.5 * d_plain,
          f"compiled wave {d_comp} from float32, plain {d_plain}")
    with torch.no_grad():
        ms_plain = time_ms(torch, lambda: engine._decode_wave(engine.cache, toks_w, pos_w),
                           flush, reps=SLOT["wave_reps"])
        ms_comp = time_ms(torch, lambda: e2._decode_wave(e2.cache, toks_w, pos_w), flush,
                          reps=SLOT["wave_reps"])
    print(f"[slot] decode wave {ms_comp:.3f} ms compiled, {ms_plain:.3f} ms plain (CUDA-event"
          f" medians of {SLOT['wave_reps']}, 2 rows of 8192 cache slots, 32 layers); {card}")
    obs = obs_slot_wave(torch, e2, Request, reqs[2].prompt, (e2.cache, toks_w, pos_w), card)
    del engine
    torch.cuda.empty_cache()
    before = stats.snapshot()
    compiles = e2.exec_stats["wave_compiles"]
    e2.reconfigure(max_len=SLOT["second_max_len"])
    dr = stats.delta(before)
    print(f"[slot] reconfigure(max_len={SLOT['second_max_len']}): exec_len {e2.exec_len},"
          f" bucket_exec_hits {dr['bucket_exec_hits']}, trace_calls {dr['trace_calls']},"
          f" search_passes {dr['search_passes']}, wave_compiles"
          f" {e2.exec_stats['wave_compiles']} (was {compiles})")
    check(e2.exec_len == 16384 and dr["bucket_exec_hits"] == 1 and dr["trace_calls"] == 0
          and dr["search_passes"] == 0 and e2.exec_stats["wave_compiles"] == compiles,
          f"slot reconfigure inside the bucket: {dr}")
    del e2, model
    M._AC_CACHE.clear()
    torch.cuda.empty_cache()

    # float32 at 4 layers; slot 0 ends holding rid 2 (admitted first into
    # the freed slots), slot 1 rid 1
    fp32 = served_fp32_logits(torch, M, ServeEngine, Request,
                              cfg.with_(dtype="float32", n_layers=SLOT["fp32_layers"]), SLOT, 14,
                              "slot", (2, 1), card)
    cli = slot_cli(torch)
    return dict(build_s=build_s, exec_len=16384, ring_width=width, cache_bytes=cache_bytes,
                wall_s=wall, tokens=toks, tok_s=toks / wall, decode_waves=waves,
                ttft_s=ttft, computed_attention_launches=n_comp,
                masked_attention_launches=n_mask, chunked_ffn_launches=n_ffn,
                plans={str(k): v for k, v in plans.items()}, plain_swapped_equal=same,
                wave_err=wave_err, wave_err_from_fp32=d_comp, plain_wave_err_from_fp32=d_plain,
                wave_ms=ms_comp, plain_wave_ms=ms_plain,
                wave_stages=len(res.plan), wave_build_s=wave_build, fp32=fp32, cli=cli,
                obs=obs,
                attention_errs={f"{k}/{dt}": v for (k, dt), v in errs.items()}, errs=errs)


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


# ---------------------------------------------------------------------------
# The fixed-slot engine on the recurrent families: mamba2-1.3b and
# recurrentgemma-9b served at full width, each prefill on the scan kernels
# ---------------------------------------------------------------------------

# the models of phases 15 and 16, rebuilt from the same seeds; each prompt
# list's first is past recurrentgemma's 2048-token window (the ring rolled
# at prefill) and the third waits for a freed slot, whose state rows it
# overwrites
SLOT_SSM = dict(
    max_batch=2, max_new=(64, 64, 32), wave_reps=10,
    models={
        "mamba2-1.3b": dict(seed=8, max_len=8320, prompts=(8192, 1000, 2000),
                            budget=SSM_RUN["budget"], fp32_layers=SSM_RUN["check_layers"],
                            wave_budget=0.5),
        "recurrentgemma-9b": dict(seed=9, max_len=4352, prompts=(4096, 1000, 600),
                                  budget=HYBRID_RUN["budget"],
                                  fp32_layers=HYBRID_RUN["check_layers"], wave_budget=None),
    },
    cli=["--local", "--device", "cuda", "--max-batch", "2", "--requests", "3",
         "--prompt-len", "64", "--max-new", "8", "--max-len", "128"])


def prefill_tag(cfg, i):
    """The per-block prefill's compile tag of layer ``i``."""
    if cfg.family == "ssm":
        return "ssm_prefill"
    return "hyb_attn" if cfg.is_attention_layer(i) else "hyb_rg_prefill"


def cache_bytes(torch, M, cfg, cache):
    """Bytes of the engine's cache by leaf kind (K/V, states, conv windows),
    and those the configuration gives: f32 states, conv windows of W-1 rows
    and K/V rings in the model's dtype."""
    got = collections.Counter()
    layers = cache["layers"]
    for c in ([layers] if isinstance(layers, dict) else layers):
        for k, t in c.items():
            got["kv" if k in ("k", "v") else k] += t.numel() * t.element_size()
    B, item = SLOT_SSM["max_batch"], torch.tensor([], dtype=cfg.torch_dtype).element_size()
    kinds = M.layer_kinds(cfg)
    want = collections.Counter()
    if cfg.family == "ssm":
        want["state"] = B * cfg.n_layers * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        want["conv"] = (B * cfg.n_layers * (cfg.ssm_conv_width - 1)
                        * (cfg.d_inner + 2 * cfg.ssm_state) * item)
    else:
        n_rg = kinds.count("rglru")
        width = layers[kinds.index("local_attn")]["k"].shape[1]
        want["kv"] = (B * (cfg.n_layers - n_rg) * 2 * width * cfg.n_kv_heads * cfg.hd * item)
        want["state"] = B * n_rg * cfg.d_model * 4
        want["conv"] = B * n_rg * (cfg.rglru_conv_width - 1) * cfg.d_model * item
    return dict(got), dict(want)


def hold_ssd_call(torch, SS, label, args, kw, errs, card):
    """One captured ``ssd_scan`` call against its plain version: y within
    the scan limit of its dtype, the final state within the f32 one."""
    x, dt, A, B, C = args
    q = min(kw.get("chunk", 128), x.shape[1])
    y, st = SS.ssd_scan(*args, **kw)
    torch.cuda.synchronize()
    y0, st0 = SS.ssd_scan_plain(x, dt, A, B, C, q)
    acum, carry = chunk_cumsums(torch, dt, A, q)
    terms = q + B.shape[-1] + acum
    dt_name = str(x.dtype).removeprefix("torch.")
    lab = f"{label} {dt_name} s={x.shape[1]} chunk={q} max|a_cum|={acum:.1f}"
    tol, why = scan_tol(dt_name, terms, y0)
    errs["ssd_scan", dt_name] = max(errs.get(("ssd_scan", dt_name), 0.0),
                                    compare(torch, "ssd_scan", f"y {lab}", y, y0, tol,
                                            f"{why}; {card}"))
    tol, why = scan_tol("float32", terms, st0)
    errs["ssd_scan", "state"] = max(errs.get(("ssd_scan", "state"), 0.0),
                                    compare(torch, "ssd_scan", f"state {lab}", st, st0, tol,
                                            f"{why}; {card}"))


def recurrent_block_plans(torch, CA, SS, RS, M, cfg, model, prompts, errs, card):
    """For each prompt length the engine served (``prompts``: length -> a
    prompt), each prefill block's plan (replayed, no search) on the first
    layer of its kind, fed that layer's own input: stages, dispatched
    loops, the predicted against the measured peak (within 5%); and the
    kernels on those inputs against their plain versions: the scan of the
    eager block (the compiled block calls the kernel op directly) and, for
    the hybrid, ``computed_attention`` as the compiled attention block calls
    it.  The plan is the one serving compiled for that shape; tracing it
    again replays it, or searches again where a sibling length of its
    shape bucket replaced the bucket's plan, and must find the same."""
    from repro_torch.core import stats

    cfs = {key[2]: cf for key, cf in M._AC_CACHE.items()}
    tags = {prefill_tag(cfg, i) for i in range(cfg.n_layers)}
    check(tags <= set(cfs), f"prefill plans {sorted(cfs)}, want {sorted(tags)}")
    out = {}
    for S, prompt in prompts.items():
        h = M.embed_inputs(cfg, model, {"tokens": torch.tensor([prompt], device="cuda")})[0]
        inputs = {}
        with torch.no_grad():
            for i in range(cfg.n_layers):
                tag = prefill_tag(cfg, i)
                p = M._index_tree(model["blocks"], i) if cfg.scan_layers else \
                    M._index_tree(model["blocks"][i])
                inputs.setdefault(tag, (i, p, h))
                if len(inputs) == len(tags):
                    break
                y = cfs[tag](p, h)
                h = y if tag == "hyb_attn" else y[0]
        out[S] = {}
        for tag, (i, p, x) in inputs.items():
            cf = cfs[tag]
            served = cf._compiled[cf._shape_key((p, x))].result
            before = stats.snapshot()
            planned = cf.trace(p, x).search()
            searched = stats.delta(before)["search_passes"]
            loops = block_loops(planned)
            pred, stages = served.final_peak, len(served.plan)
            check(len(planned.plan.stages) == stages and planned.final_peak == pred,
                  f"{tag} S={S}: traced again, {len(planned.plan.stages)} stages and"
                  f" {planned.final_peak} B; served {stages} and {pred} B")
            del planned
            with torch.no_grad():
                cf(p, x)
                _, peak, ms = measure_forward(torch, cf, (p, x))
            attn = loops.get("attention", (0, 0))
            print(f"[slot-ssm] {cfg.name} block plan {tag} S={S} budget {cfg.autochunk_budget}"
                  f" (layer {i}'s own input; traced again: {searched} search passes):"
                  f" {stages} stages, dispatched loops {loops};"
                  f" activation peak {peak} B against predicted"
                  f" {pred} B ({peak / pred:.4f}x); {ms:.2f} ms; {card}")
            check(abs(peak - pred) <= 0.05 * pred,
                  f"{cfg.name} {tag} S={S}: peak {peak} B not within 5% of the predicted"
                  f" {pred} B")
            with torch.no_grad():
                if tag == "ssm_prefill":
                    (call,) = capture_calls(torch, SS, "ssd_scan",
                                            lambda: M.ssm_block_state(cfg, p, x))
                    hold_ssd_call(torch, SS, f"slot prefill S={S} layer {i}", *call, errs, card)
                elif tag == "hyb_rg_prefill":
                    ((a, b), kw), = capture_calls(torch, RS, "rglru_scan",
                                                  lambda: M.rg_block_state(cfg, p, x))
                    dt_name = str(a.dtype).removeprefix("torch.")
                    err = hold(torch, "rglru_scan", f"slot prefill S={S} layer {i} {dt_name}"
                               f" D={a.shape[2]}", lambda: RS.rglru_scan(a, b, **kw),
                               lambda: RS.rglru_scan_plain(a, b), TOL["float32"])
                    errs["rglru_scan", dt_name] = max(errs.get(("rglru_scan", dt_name), 0.0),
                                                      err)
                else:
                    comp = []
                    masked = capture_calls(torch, CA, "masked_attention", lambda: comp.extend(
                        capture_calls(torch, CA, "computed_attention", lambda: cf(p, x))))
                    for kname, kcalls in (("computed_attention", comp),
                                          ("masked_attention", masked)):
                        for j, (args, kw) in enumerate(kcalls):
                            dt_name = str(args[0].dtype).removeprefix("torch.")
                            err = hold(torch, kname, f"slot prefill S={S} layer {i} call {j}"
                                       f" {dt_name} Sq={args[0].shape[1]} Skv={args[1].shape[1]}"
                                       f" H={args[0].shape[0]} Kv={args[1].shape[0]}"
                                       f" hd={args[0].shape[2]}",
                                       lambda: getattr(CA, kname)(*args, **kw),
                                       lambda: getattr(CA, f"{kname}_plain")(*args, **kw),
                                       TOL[dt_name])
                            errs[kname, dt_name] = max(errs.get((kname, dt_name), 0.0), err)
                    check(len(comp) + len(masked) == attn[1],
                          f"{tag} S={S}: {len(comp)} + {len(masked)} attention calls, plan"
                          f" {attn}")
            out[S][tag] = dict(layer=i, stages=stages, loops={k: list(v) for k, v in loops.items()},
                               pred_peak=pred, peak=peak, ms=ms)
        del h, inputs
    return out


def recurrent_wave(torch, M, ServeEngine, stats, cfg, model, engine, reqs, flush, card):
    """mamba2's decode wave compiled at its ``wave_budget`` beside the plain
    wave, from the same cache, tokens and positions: build time, stages,
    dispatch hits and misses; both bf16 waves against the float32 wave of
    the same weights and cache (the compiled no further than 1.5x the
    plain); the caches the two wrote."""
    run = SLOT_SSM["models"][cfg.name]
    before = stats.snapshot()
    t0 = time.perf_counter()
    e2 = ServeEngine(cfg, model, max_batch=SLOT_SSM["max_batch"], max_len=run["max_len"],
                     autochunk_budget=run["wave_budget"], device="cuda")
    build = time.perf_counter() - t0
    dw = stats.delta(before)
    res = e2.autochunk_result
    for full, mine in zip(torch.utils._pytree.tree_leaves(e2.cache),
                          torch.utils._pytree.tree_leaves(engine.cache)):
        full.copy_(mine)
    # slot 0 holds rid 2 (admitted into the first freed slot), slot 1 rid 1
    toks = torch.tensor([reqs[2].generated[-1], reqs[1].generated[-1]], device="cuda")
    pos = torch.tensor([len(r.prompt) + len(r.generated) for r in (reqs[2], reqs[1])],
                       device="cuda")
    print(f"[slot-ssm] {cfg.name} compiled wave (budget {run['wave_budget']}): built in"
          f" {build:.2f}s ({dw['trace_calls']} trace, {dw['search_passes']} search passes),"
          f" {len(res.plan)} stages, predicted peak {res.baseline_peak} -> {res.final_peak} B"
          f" (budget {res.budget_bytes} B); dispatch hits {dw['kernel_dispatch_hits']}, misses"
          f" {dw['kernel_dispatch_misses']}; {card}")
    with torch.no_grad():
        params32 = {k: v.float() for k, v in model.named_parameters()}
        # a copy of every leaf (the f32 states too): the wave writes it
        cache32 = torch.utils._pytree.tree_map(
            lambda t: t.to(torch.float32, copy=True), e2.cache)
        ref = M.decode_fn(model)(params32, cache32, toks, pos)[:, :cfg.vocab_size]
        del params32, cache32
        torch.cuda.empty_cache()
        plain = engine._decode_wave(engine.cache, toks, pos)[:, :cfg.vocab_size]
        comp = e2._decode_wave(e2.cache, toks, pos)[:, :cfg.vocab_size]
    err = float((comp.float() - plain.float()).abs().max())
    d_comp = float((comp.float() - ref).abs().max())
    d_plain = float((plain.float() - ref).abs().max())
    cache_err = max(float((a.float() - b.float()).abs().max()) for a, b in
                    zip(torch.utils._pytree.tree_leaves(e2.cache),
                        torch.utils._pytree.tree_leaves(engine.cache)))
    print(f"[slot-ssm] {cfg.name} compiled wave against the plain one, bf16 logits: max_abs_err"
          f" {err:.3e}; from the float32 wave: compiled {d_comp:.3e}, plain {d_plain:.3e} (limit"
          f" 1.5x the plain's); caches after the wave max_abs_err {cache_err:.3e}")
    check(bool(torch.isfinite(comp).all()) and d_comp <= 1.5 * d_plain,
          f"{cfg.name} compiled wave {d_comp} from float32, plain {d_plain}")
    with torch.no_grad():
        ms = time_ms(torch, lambda: e2._decode_wave(e2.cache, toks, pos), flush,
                     reps=SLOT_SSM["wave_reps"])
    del e2
    torch.cuda.empty_cache()
    return dict(build_s=build, stages=len(res.plan), pred_peak0=res.baseline_peak,
                pred_peak1=res.final_peak, dispatch_hits=dw["kernel_dispatch_hits"],
                dispatch_misses=dw["kernel_dispatch_misses"], err=err, err_from_fp32=d_comp,
                plain_err_from_fp32=d_plain, cache_err=cache_err, ms=ms)


def recurrent_fp32_logits(torch, M, ServeEngine, Request, arch, card):
    """At the run's float32 depth: rid 0 served alone, its decode logits at
    the first wave, the second and the last against the forward over its
    sequence so far (limit 1e-3; for recurrentgemma the first wave writes
    position 4096, a multiple of its 2048-token ring, and the second reads
    across it); for mamba2 also the wave compiled at its ``wave_budget``
    against the plain one (float32 ``TOL``, caches within 1e-4)."""
    from repro_torch.configs import get_config

    run = SLOT_SSM["models"][arch]
    cfg = get_config(arch).with_(dtype="float32", n_layers=run["fp32_layers"])
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(run["seed"]),
                          device="cuda")
    M._AC_CACHE.clear()
    engine = ServeEngine(cfg.with_(autochunk_budget=run["budget"]), model,
                         max_batch=SLOT_SSM["max_batch"], max_len=run["max_len"], device="cuda")
    (req,) = make_requests(Request, cfg.vocab_size, run["seed"], run["prompts"][:1],
                           SLOT_SSM["max_new"][:1])
    waves = {"first": 0, "second": 1, "last": req.max_new_tokens - 2}
    kept, wave = {}, engine._decode_wave

    def spy(cache, toks, pos):
        logits = wave(cache, toks, pos)
        for name, at in waves.items():
            if engine.n_decode_steps == at:
                kept[name] = (int(pos[0]), logits[0].float().clone())
        return logits

    engine._decode_wave = spy
    engine.submit(req)
    engine.run()
    engine._decode_wave = wave      # the spy holds the engine: no reference cycle
    check(req.done and len(req.generated) == req.max_new_tokens,
          f"fp32 {arch} serving: the request did not finish")
    out = {}
    if run["wave_budget"] is not None:
        e2 = ServeEngine(cfg, model, max_batch=SLOT_SSM["max_batch"], max_len=run["max_len"],
                         autochunk_budget=run["wave_budget"], device="cuda")
        for full, mine in zip(torch.utils._pytree.tree_leaves(e2.cache),
                              torch.utils._pytree.tree_leaves(engine.cache)):
            full.copy_(mine)
        toks = torch.tensor([req.generated[-1], 0], device="cuda")
        pos = torch.tensor([len(req.prompt) + len(req.generated) - 1, 0], device="cuda")
        with torch.no_grad():
            want = wave(engine.cache, toks, pos)[:, :cfg.vocab_size]
            got = e2._decode_wave(e2.cache, toks, pos)[:, :cfg.vocab_size]
        out["compiled_wave_err"] = compare(
            torch, "decode wave", f"{arch} fp32 L={cfg.n_layers} compiled (budget"
            f" {run['wave_budget']}, {len(e2.autochunk_result.plan)} stages) against plain",
            got, want, TOL["float32"])
        out["compiled_wave_cache_err"] = max(
            float((a - b).abs().max()) for a, b in zip(torch.utils._pytree.tree_leaves(e2.cache),
                                                       torch.utils._pytree.tree_leaves(engine.cache)))
        print(f"[slot-ssm] {arch} fp32 caches after the wave: max_abs_err"
              f" {out['compiled_wave_cache_err']:.3e} (limit 1e-4)")
        check(out["compiled_wave_cache_err"] <= 1e-4,
              f"the compiled {arch} wave wrote another cache")
        del e2
    seq = req.prompt + req.generated
    errs = {}
    with torch.no_grad():
        for name, (pos, got) in kept.items():
            toks = torch.tensor([seq[:pos + 1]], device="cuda")
            want = M.forward(cfg, model, {"tokens": toks})[0][0, -1]
            errs[name] = float((got[:cfg.vocab_size] - want[:cfg.vocab_size].float())
                               .abs().max())
            del want
            torch.cuda.empty_cache()
    print(f"[slot-ssm] {arch} fp32 L={cfg.n_layers}: rid 0 decode logits against forward over"
          f" the sequence so far: " + ", ".join(f"{k} wave (position {kept[k][0]}) {v:.3e}"
                                                for k, v in errs.items())
          + f" (limit 1e-3); {card}")
    check(max(errs.values()) <= 1e-3, f"fp32 {arch} served logits differ from the forward:"
          f" {errs}")
    M._AC_CACHE.clear()
    del engine, model
    torch.cuda.empty_cache()
    return out | {f"{k}_position": kept[k][0] for k in kept} | {f"{k}_err": v
                                                               for k, v in errs.items()}


def serve_recurrent(torch, CA, SS, RS, stats, M, flush, card, arch):
    """One recurrent model at full width and depth, bf16, through
    ``ServeEngine``: 2 slots, three requests (the third in a freed slot),
    each prefill per block under the run's budget with the launch counts
    zeroed just before serving and read just after; the block plans and
    the kernels on the layers' own inputs; the same requests with the plain
    versions swapped in (the prefill unbudgeted: the compiled blocks call
    the scan ops directly); the plain wave's time and, for mamba2, the
    compiled wave; float32 served logits at the run's depth."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Request, ServeEngine

    run = SLOT_SSM["models"][arch]
    cfg = get_config(arch)                                   # bf16, full depth
    cfg_ac = cfg.with_(autochunk_budget=run["budget"])
    kinds = M.layer_kinds(cfg)
    n_rec, n_attn = sum(k != "local_attn" for k in kinds), kinds.count("local_attn")
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(run["seed"]),
                          device="cuda")
    M._AC_CACHE.clear()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg_ac, model, max_batch=SLOT_SSM["max_batch"], max_len=run["max_len"],
                         device="cuda")
    build_s = time.perf_counter() - t0
    exec_len = engine.exec_len
    got, want = cache_bytes(torch, M, cfg, engine.cache)
    print(f"[slot-ssm] {arch} engine built in {build_s:.2f}s: {SLOT_SSM['max_batch']} slots,"
          f" max_len {run['max_len']}, exec_len {exec_len}, cache bytes {got} (from the"
          f" configuration {want}); {n_rec} recurrent and {n_attn} attention layers")
    check(got == want, f"{arch} slot cache {got}, want {want}")

    reqs = make_requests(Request, cfg.vocab_size, run["seed"], run["prompts"],
                         SLOT_SSM["max_new"])
    torch.cuda.synchronize()
    SS.ssd_scan.launches = RS.rglru_scan.launches = 0
    CA.computed_attention.launches = CA.masked_attention.launches = 0
    before = stats.snapshot()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ssd_scan": SS.ssd_scan.launches, "rglru_scan": RS.rglru_scan.launches,
                "computed_attention": CA.computed_attention.launches,
                "masked_attention": CA.masked_attention.launches}
    d = stats.delta(before)
    max_new = SLOT_SSM["max_new"]
    toks = sum(len(r.generated) for r in reqs)
    check(all(r.done and len(r.generated) == m for r, m in zip(reqs, max_new)),
          f"{arch} slot serving: a request did not finish with its new tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"{arch} slot serving: a token outside the vocabulary")
    waves = engine.n_decode_steps
    check(waves == max_new[0] - 1 + max_new[2] - 1, f"{arch} slot serving: {waves} waves")
    ttft = {r.rid: r.ttft_s for r in reqs}
    print(f"[slot-ssm] {arch} served {len(reqs)} requests (prompts {run['prompts']}, new"
          f" {max_new}) on {SLOT_SSM['max_batch']} slots, prefill per block at budget"
          f" {run['budget']}: {toks} tokens in {wall:.3f}s = {toks / wall:.1f} tok/s, {waves}"
          f" decode waves; TTFT {', '.join(f'rid {k} {v:.3f}s' for k, v in ttft.items())};"
          f" block compiles {d['search_passes']} search passes; {card}")

    errs = {}
    first = {}
    for r in reqs:
        first.setdefault(len(r.prompt), r.prompt)
    plans = recurrent_block_plans(torch, CA, SS, RS, M, cfg_ac, model, first, errs, card)
    scan = "ssd_scan" if cfg.family == "ssm" else "rglru_scan"
    want_scan = len(reqs) * n_rec
    want_attn = sum(n_attn * plans[len(r.prompt)]["hyb_attn"]["loops"].get(
        "attention", [0, 0])[1] for r in reqs) if n_attn else 0
    print(f"[slot-ssm] {arch} launches while serving: {launches} ({scan} = {len(reqs)} prefills"
          f" x {n_rec} layers = {want_scan}; computed_attention + masked_attention = sum over"
          f" the prefills of {n_attn} layers x attention chunks = {want_attn})")
    check(launches[scan] == want_scan and launches["computed_attention"]
          + launches["masked_attention"] == want_attn,
          f"{arch} launches {launches}: {scan} want {want_scan}, attention want {want_attn}")
    check(cfg.family == "ssm" or launches["computed_attention"] > 0,
          f"{arch}: no prefill ran computed_attention")

    # the plain wave's time, from the cache the run left
    toks_w = torch.tensor([reqs[2].generated[-1], reqs[1].generated[-1]], device="cuda")
    pos_w = torch.tensor([len(r.prompt) + len(r.generated) for r in (reqs[2], reqs[1])],
                         device="cuda")
    wave = None
    if run["wave_budget"] is not None:
        wave = recurrent_wave(torch, M, ServeEngine, stats, cfg_ac, model, engine, reqs, flush,
                              card)
    with torch.no_grad():
        ms = time_ms(torch, lambda: engine._decode_wave(engine.cache, toks_w, pos_w), flush,
                     reps=SLOT_SSM["wave_reps"])
    print(f"[slot-ssm] {arch} decode wave {ms:.3f} ms plain"
          + (f", {wave['ms']:.3f} ms compiled" if wave else "")
          + f" (CUDA-event medians of {SLOT_SSM['wave_reps']}, 2 rows, {cfg.n_layers} layers);"
          f" {card}")
    del engine
    torch.cuda.empty_cache()

    # the same requests with the scans' plain versions swapped in
    # (information); the prefill unbudgeted, so that the model calls the
    # scans' module functions (a compiled block calls the ops) and the
    # attention runs generic
    e_plain = ServeEngine(cfg, model, max_batch=SLOT_SSM["max_batch"], max_len=run["max_len"],
                          device="cuda")
    plain_reqs = [Request(rid=100 + r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                  for r in reqs]
    for r in plain_reqs:
        e_plain.submit(r)
    run_plain(SS, RS, e_plain.run)
    same = sum(a == b for r, rp in zip(reqs, plain_reqs)
               for a, b in zip(r.generated, rp.generated))
    print(f"[slot-ssm] {arch} the same requests with the plain versions swapped in (prefill"
          f" unbudgeted): {same} of {toks} tokens equal to the kernels'")
    del e_plain, model
    M._AC_CACHE.clear()
    torch.cuda.empty_cache()
    fp32 = recurrent_fp32_logits(torch, M, ServeEngine, Request, arch, card)
    return dict(build_s=build_s, exec_len=exec_len, cache_bytes=got,
                wall_s=wall, tokens=toks, tok_s=toks / wall, decode_waves=waves, ttft_s=ttft,
                launches=launches, plans={str(k): v for k, v in plans.items()},
                plain_swapped_equal=same, wave_ms=ms, compiled_wave=wave, fp32=fp32,
                errs=errs)


def recurrent_cli(torch):
    """``serve.main`` without ``--paged`` on the card, each recurrent family
    at reduced size: its ``[serve]`` requests line."""
    import contextlib
    import io

    from repro_torch.launch import serve

    out = {}
    for arch in SLOT_SSM["models"]:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            serve.main(["--arch", arch] + SLOT_SSM["cli"])
        lines = [ln for ln in text.getvalue().splitlines() if ln.startswith("[serve]")]
        for ln in lines:
            print(f"[slot-ssm] CLI {arch}: {ln}")
        check(any(re.match(r"\[serve\] 3 requests, 24 tokens ", ln) for ln in lines),
              f"the serving CLI did not serve {arch}")
        out[arch] = lines
    torch.cuda.empty_cache()
    return out


def run_slot_ssm_phase(torch, CA, SS, RS, stats, M, flush, card):
    """mamba2-1.3b, then recurrentgemma-9b (the first freed before the
    second is built), then the CLI at reduced size."""
    out = {arch: serve_recurrent(torch, CA, SS, RS, stats, M, flush, card, arch)
           for arch in SLOT_SSM["models"]}
    out["cli"] = recurrent_cli(torch)
    return out


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


# ---------------------------------------------------------------------------
# The MoE family: qwen2-moe-a2.7b's forward per block
# ---------------------------------------------------------------------------

MOE_RUN = dict(arch="qwen2-moe-a2.7b", seq_len=8192, budget=0.04, seed=13,
               # depths of the float32 and bf16-against-float32 checks
               fp32_layers=2, bf16_layers=4)


def param_bytes(tree):
    """Bytes of a module tree's parameters, of a dict of tensors (a stacked
    layer: a dict of views) or of one tensor."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    ts = tree.parameters() if hasattr(tree, "parameters") else [tree]
    return sum(t.numel() * t.element_size() for t in ts)


def moe_weight_bytes(model):
    """Bytes of one MoE layer's weights by part, of the embedding and of
    the whole model (the list or the stacked form)."""
    nb = param_bytes
    p = model.layer_params(0)
    moe = p["moe"]
    return dict(experts=nb(moe["w_up"]) + nb(moe["w_down"]), shared=nb(moe["shared"]),
                attention=nb(p["attn"]), router=nb(moe["router"]),
                embedding=nb(model["embed"]), total=nb(model))


def all_loops(planned):
    """[(dispatch kinds or ("generic",), rows or slots per chunk, trips)] of
    every chunk loop of a planned block."""
    from repro_torch.core.lowering import is_chunk_loop

    return [(tuple(d.kind for d in n.params["dispatches"]) or ("generic",), n.params["c"],
             n.params["n_iters"]) for n in planned.graph.nodes if is_chunk_loop(n)]


def live_at_peak(planned, top=4):
    """The largest values live at a planned graph's predicted peak, as
    (bytes, op, shape), beside the peak node's own loop body."""
    from repro_torch.core.estimation import estimate_memory
    from repro_torch.core.graph import op_name, vshape

    g = planned.graph
    i = estimate_memory(g).peak_node
    live = [(g.node_bytes(v), op_name(v), vshape(v)) for v, last in g.last_use.items()
            if g.producer.get(v) is not None and g.producer[v] <= i <= last and g.node_bytes(v)]
    return sorted(live, key=lambda t: -t[0])[:top]


def capture_ffn_calls(torch, CF, fn):
    """``fn()`` with every ``chunked_ffn`` call's x copied and its weights
    kept as the views the path hands over; the kernel runs as usual."""
    wrapped, calls = CF.chunked_ffn, []

    def spy(x, wg, wu, wd, **kw):
        calls.append((x.clone(), wg, wu, wd))
        return wrapped(x, wg, wu, wd, **kw)

    spy.launches = wrapped.launches
    CF.chunked_ffn = spy
    try:
        with torch.no_grad():
            fn()
    finally:
        CF.chunked_ffn = wrapped
        wrapped.launches = spy.launches
    return calls


def moe_layer0_routes(torch, M, cfg, p0, h0, window=None):
    """Layer 0's expert indices (S, k) in the unchunked block."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE

    with torch.no_grad():
        x = M.attn_apply_full(cfg, p0, h0, None, window=window, causal=True)
        h = L.apply_norm(cfg, x, p0["ln2"])
        return MOE.route(cfg, h.reshape(-1, cfg.d_model), p0["moe"]["router"])[0]


def moe_block_with_routes(M, cfg):
    """The MoE block that also hands back its router's expert indices."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE

    def block(p, x):
        x = M.attn_apply_full(cfg, p, x, None, window=None, causal=True)
        h = L.apply_norm(cfg, x, p["ln2"])
        idx = MOE.route(cfg, h.reshape(-1, cfg.d_model), p["moe"]["router"])[0]
        ff, aux = MOE.moe_ffn(cfg, p["moe"], h)
        return x + ff, aux, idx
    return block


def run_moe_forward(torch, CA, CF, stats, M, card, attn_errs, ffn_errs):
    """qwen2-moe-a2.7b at full width and depth, bf16, random weights: one
    forward of S 8192 unbudgeted, then per block at budget 0.04 (one MoE
    block compiled at layer 0, replayed for the other 23; its attention on
    ``computed_attention``, its shared expert's SwiGLU on ``chunked_ffn``,
    its routed experts a generic loop), counts zeroed just before and read
    just after; the block's plan and layer-0 peaks (within 5% of the
    prediction), both kernels on layer 0's own calls against their plain
    versions, and the assignments layer 0 drops at capacity."""
    from repro_torch.configs import get_config
    from repro_torch.core import ChunkConfig, autochunk
    from repro_torch.models import moe as MOE

    # the list form: stacking 24 layers would hold the weights twice at once
    cfg = get_config(MOE_RUN["arch"]).with_(scan_layers=False)
    cfg_ac = cfg.with_(autochunk_budget=MOE_RUN["budget"])
    S, L, E = MOE_RUN["seq_len"], cfg.n_layers, cfg.n_experts_padded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(MOE_RUN["seed"]),
                          device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    wb = moe_weight_bytes(model)
    print(f"[moe] qwen2-moe-a2.7b bf16 L={L} d={cfg.d_model} H={cfg.n_heads} hd={cfg.hd}"
          f" experts {cfg.n_experts} (padded {E}) top-{cfg.experts_per_token} f={cfg.moe_d_ff},"
          f" {cfg.n_shared_experts} shared (f {cfg.n_shared_experts * cfg.moe_d_ff}), vocab"
          f" {cfg.vocab_size}: weights built on the card in {build_s:.2f}s, {wb['total']} B"
          f" (per layer: routed experts {wb['experts']} B, shared expert {wb['shared']} B,"
          f" attention {wb['attention']} B, router {wb['router']} B; embedding and head"
          f" {wb['embedding']} B)")
    batch = block_batch(torch, cfg, MOE_RUN["seed"])

    # the unbudgeted forward
    def unchunked():
        return M.forward(cfg, model, batch)

    def per_block():
        return M.forward(cfg_ac, model, batch)

    with torch.no_grad():
        unchunked()
        (y0, aux0), peak0, ms0 = measure_forward(torch, unchunked, ())

    # layer 0's routing at capacity: the assignments beyond each expert's cap
    p0m = model.layer_params(0)
    p0 = M._index_tree(p0m)
    h0 = M.embed_inputs(cfg, model, batch)[0]
    cap = MOE.capacity(cfg, S)
    idx0 = moe_layer0_routes(torch, M, cfg, p0m, h0)
    counts = torch.bincount(idx0.flatten(), minlength=E)
    dropped = int((counts - cap).clamp(min=0).sum())
    over = int((counts > cap).sum())
    print(f"[moe] layer 0 routing at S={S}: capacity {cap} a expert; assignments per expert"
          f" min {int(counts[:cfg.n_experts].min())} max {int(counts.max())}; {over} experts"
          f" over capacity, {dropped} of {S * cfg.experts_per_token} assignments dropped")
    check(cap == 640, f"capacity {cap}, want 640")
    check(int(counts[cfg.n_experts:].sum()) == 0, "a padding expert was routed to")

    # the first per-block forward: one search at layer 0, 23 replays
    M._AC_CACHE.clear()
    before = stats.snapshot()
    t0 = time.perf_counter()
    with torch.no_grad():
        y1, aux1 = per_block()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    d = stats.delta(before)
    del y1
    (cf,) = M._AC_CACHE.values()
    r = cf.autochunk_result
    before = stats.snapshot()
    planned = cf.trace(p0, h0).search()
    check(stats.delta(before)["search_passes"] == 0, "the replay searched")
    loops, live = all_loops(planned), live_at_peak(planned)
    del planned
    kinds = {k[0]: (c, n) for k, c, n in loops if k != ("generic",)}
    n_generic = sum(k == ("generic",) for k, _, _ in loops)
    check(cf.counters["compiles"] == 1 and cf.counters["shape_hits"] == L - 1,
          f"first forward: {cf.stats()}, want 1 compile and {L - 1} replays")
    check(set(kinds) == {"attention", "swiglu"},
          f"dispatched loops {loops}: want attention and SwiGLU")
    check(d["kernel_dispatch_hits"] == 2 and d["kernel_dispatch_computed_mask"] == 1
          and d["kernel_dispatch_misses"] == n_generic,
          f"dispatch hits {d['kernel_dispatch_hits']} (computed"
          f" {d['kernel_dispatch_computed_mask']}), misses {d['kernel_dispatch_misses']};"
          f" want attention and the shared SwiGLU, and a miss for each of {n_generic}"
          " generic loops")
    print(f"[block] moe: first per-block forward {first_s:.2f}s, one block compile (host"
          f" seconds trace {r.trace_s:.2f}, search {r.search_s:.2f}, compile"
          f" {r.elapsed_s - r.trace_s - r.search_s:.2f}; {d['search_passes']} search passes),"
          f" {cf.counters['shape_hits']} replays; {len(r.plan)} stages; predicted block peak"
          f" {r.baseline_peak} B -> {r.final_peak} B (budget {r.budget_bytes} B); dispatch"
          f" hits {d['kernel_dispatch_hits']}, misses {d['kernel_dispatch_misses']}")
    for kind, c, n in loops:
        print(f"[block] moe loop {'+'.join(kind)}: {n} chunks of {c}")
    print("[block] moe values live at the predicted peak: "
          + ", ".join(f"{op} {tuple(shape)} {b} B" for b, op, shape in live))
    for line in r.report().splitlines()[6:]:
        print(f"[block] {line.strip()}")

    def block(p, x):
        return M.moe_block_full(cfg, p, x, window=None)

    with torch.no_grad():
        block(p0, h0)
        _, bpeak0, bms0 = measure_forward(torch, block, (p0, h0))
        _, bpeak1, bms1 = measure_forward(torch, cf, (p0, h0))
    print(f"[block] moe layer 0 activation peak: unchunked {bpeak0} B (predicted"
          f" {r.baseline_peak} B, {bpeak0 / r.baseline_peak:.4f}x), chunked {bpeak1} B"
          f" (predicted {r.final_peak} B, {bpeak1 / r.final_peak:.4f}x); time unchunked"
          f" {bms0:.2f} ms, chunked {bms1:.2f} ms; {card}")
    check(abs(bpeak1 - r.final_peak) <= 0.05 * r.final_peak,
          f"moe chunked block peak {bpeak1} B is not within 5% of the predicted {r.final_peak} B")

    # both kernels on layer 0's own calls
    calls = capture_calls(torch, CA, "computed_attention", lambda: cf(p0, h0))
    check(len(calls) == kinds["attention"][1],
          f"{len(calls)} attention calls in one block, want {kinds['attention'][1]}")
    attn_check = check_block_attention(torch, CA, calls, attn_errs)
    del calls
    fcalls = capture_ffn_calls(torch, CF, lambda: cf(p0, h0))
    check(len(fcalls) == kinds["swiglu"][1],
          f"{len(fcalls)} chunked_ffn calls in one block, want {kinds['swiglu'][1]}")
    for i, (x, wg, wu, wd) in enumerate(fcalls):
        dt_name = str(x.dtype).removeprefix("torch.")
        err = hold(torch, "chunked_ffn", f"moe shared expert chunk {i} of layer 0 {dt_name}"
                   f" rows={x.shape[0]} d={x.shape[1]} f={wg.shape[1]}",
                   lambda: CF.chunked_ffn(x, wg, wu, wd),
                   lambda: CF.chunked_ffn_plain(x, wg, wu, wd), TOL[dt_name])
        ffn_errs[dt_name] = max(ffn_errs.get(dt_name, 0.0), err)
    del fcalls

    # the whole forward per block, counts zeroed just before, read just after
    hits = cf.counters["shape_hits"]
    before = stats.snapshot()
    CA.computed_attention.launches = CA.masked_attention.launches = 0
    CF.chunked_ffn.launches = 0
    with torch.no_grad():
        (y1, aux1), peak1, ms1 = measure_forward(torch, per_block, ())
    n_ffn, n_attn = CF.chunked_ffn.launches, CA.computed_attention.launches
    n_masked = CA.masked_attention.launches
    d = stats.delta(before)
    check(d["search_passes"] == 0 and cf.counters["shape_hits"] - hits == L,
          f"second forward: {d['search_passes']} search passes,"
          f" {cf.counters['shape_hits'] - hits} replays")
    check(n_ffn == L * kinds["swiglu"][1] > 0,
          f"chunked_ffn launched {n_ffn} times, want {L} x {kinds['swiglu'][1]}")
    check(n_attn == L * kinds["attention"][1] > 0 and n_masked == 0,
          f"computed_attention launched {n_attn} times (masked {n_masked}), want {L} x"
          f" {kinds['attention'][1]}")
    check(bool(torch.isfinite(y1[..., :cfg.vocab_size]).all()), "non-finite moe logits")
    check(bool(torch.isfinite(aux1)) and float(aux1) > 0, f"moe aux loss {float(aux1)}")
    bf16_err = max_logit_err(y1, y0, cfg.vocab_size)
    print(f"[forward] qwen2-moe-a2.7b: whole-forward peak unbudgeted {peak0} B, per block"
          f" {peak1} B; time unbudgeted {ms0:.2f} ms, per block {ms1:.2f} ms; computed_attention"
          f" launches {n_attn} = {L} layers x {kinds['attention'][1]} chunks of"
          f" {kinds['attention'][0]}, chunked_ffn launches {n_ffn} = {L} layers x"
          f" {kinds['swiglu'][1]} chunks of {kinds['swiglu'][0]} rows; aux loss unbudgeted"
          f" {float(aux0):.6f}, per block {float(aux1):.6f}; bf16 logits max |delta| vs"
          f" unbudgeted {bf16_err:.3e}; {card}")
    out = dict(weight_bytes=wb, build_s=build_s, seconds_first=first_s, trace_s=r.trace_s,
               search_s=r.search_s, stages=len(r.plan),
               loops=[dict(kinds=list(k), chunk=c, chunks=n) for k, c, n in loops],
               pred_block0=r.baseline_peak, pred_block1=r.final_peak,
               budget_bytes=r.budget_bytes, live_at_peak=[list(t) for t in live],
               block_peak0=bpeak0, block_peak1=bpeak1,
               block_ms0=bms0, block_ms1=bms1, peak0=peak0, peak1=peak1, ms0=ms0, ms1=ms1,
               attention_launches=n_attn, chunked_ffn_launches=n_ffn,
               aux0=float(aux0), aux1=float(aux1), bf16_logits_err=bf16_err,
               capacity=cap, dropped_layer0=dropped, experts_over_capacity=over,
               attention_check=attn_check)
    del y0, y1, model, p0, p0m, h0, cf
    M._AC_CACHE.clear()
    torch.cuda.empty_cache()
    out.update(check_moe_logits(torch, M, card))
    return out


def check_moe_logits(torch, M, card):
    """float32 at 2 layers, full width, S 8192: per-block logits and aux
    within 1e-3 of the unbudgeted ones.  Then 4 layers in float32 and the
    same weights rounded to bf16: the per-block bf16 logits no further from
    float32 than 1.5 times the unbudgeted bf16 ones.  On a miss, how many of
    layer 0's tokens route to another top-k set in the per-block bf16 block
    than in the unbudgeted one is printed before the run fails."""
    from repro_torch.configs import get_config
    from repro_torch.core import ChunkConfig, autochunk

    base = get_config(MOE_RUN["arch"]).with_(scan_layers=False)
    budget = MOE_RUN["budget"]
    cfg = base.with_(dtype="float32", n_layers=MOE_RUN["fp32_layers"])
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(14), device="cuda")
    batch = block_batch(torch, cfg, 14)
    M._AC_CACHE.clear()
    with torch.no_grad():
        y0, a0 = M.forward(cfg, model, batch)
        y1, a1 = M.forward(cfg.with_(autochunk_budget=budget), model, batch)
    err, aerr = max_logit_err(y1, y0, cfg.vocab_size), abs(float(a1) - float(a0))
    (cf,) = M._AC_CACHE.values()
    print(f"[forward] qwen2-moe-a2.7b per-block fp32 L={cfg.n_layers} S={MOE_RUN['seq_len']}:"
          f" {len(cf.autochunk_result.plan)} stages; per-block vs unbudgeted logits max_abs_err"
          f" {err:.3e}, aux {float(a0):.6f} vs {float(a1):.6f} (|delta| {aerr:.3e}; limits 1e-3)")
    check(err <= 1e-3 and aerr <= 1e-3, f"fp32 moe per-block logits {err}, aux {aerr}")
    del y0, y1, model, cf
    M._AC_CACHE.clear()
    torch.cuda.empty_cache()

    cfg = base.with_(dtype="float32", n_layers=MOE_RUN["bf16_layers"])
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(15), device="cuda")
    batch = block_batch(torch, cfg, 15)
    with torch.no_grad():
        y32 = M.forward(cfg, model, batch)[0]
    cfg16 = cfg.with_(dtype="bfloat16")
    # the routers stay float32, as the model's init makes them
    routers = {n: p.detach().clone() for n, p in model.named_parameters()
               if n.endswith("moe.router")}
    model.to(torch.bfloat16)
    for n, p in model.named_parameters():
        if n in routers:
            p.data = routers[n]
    M._AC_CACHE.clear()
    with torch.no_grad():
        y16 = M.forward(cfg16, model, batch)[0]
        err_u = max_logit_err(y16, y32, cfg.vocab_size)
        del y16
        y16 = M.forward(cfg16.with_(autochunk_budget=budget), model, batch)[0]
    err_c = max_logit_err(y16, y32, cfg.vocab_size)
    del y16, y32
    print(f"[forward] qwen2-moe-a2.7b bf16 L={cfg.n_layers} S={MOE_RUN['seq_len']} against the"
          f" float32 logits of the same weights: unbudgeted max_abs_err {err_u:.3e}, per block"
          f" {err_c:.3e} ({err_c / err_u:.3f}x; limit 1.5x); {card}")
    flips = None
    if err_c > 1.5 * err_u:
        p0m = model.layer_params(0)
        p0 = M._index_tree(p0m)
        h0 = M.embed_inputs(cfg16, model, batch)[0]
        want = moe_layer0_routes(torch, M, cfg16, p0m, h0)
        routes = autochunk(moe_block_with_routes(M, cfg16), ChunkConfig.from_scalar(
            budget, weight_argnums=(0,), dim_blocklist=(0,)))
        got = routes(p0, h0)[2]
        flips = int((want.sort(dim=-1).values != got.sort(dim=-1).values).any(dim=-1).sum())
        print(f"[forward] qwen2-moe-a2.7b bf16: {flips} of {h0.shape[1]} layer-0 tokens route"
              " to another top-k set per block than unbudgeted")
    del model
    M._AC_CACHE.clear()
    torch.cuda.empty_cache()
    check(err_c <= 1.5 * err_u, f"bf16 moe per-block logits stray {err_c} from float32, the"
          f" unbudgeted bf16 ones {err_u}")
    return dict(fp32_logits_err=err, fp32_aux_err=aerr, bf16_vs_fp32_unchunked=err_u,
                bf16_vs_fp32_per_block=err_c, layer0_route_flips=flips)


# ---------------------------------------------------------------------------
# MoE serving: qwen2-moe-a2.7b through the fixed-slot engine
# ---------------------------------------------------------------------------

MOE_SERVE = dict(arch="qwen2-moe-a2.7b", seed=14, max_batch=2, max_len=8320, budget=0.04,
                 # the first decodes across position 8192 (the ring's first wrap at
                 # wave 64); the third is admitted into the slot the second frees
                 prompts=(8128, 1000, 2000), max_new=(128, 64, 32),
                 wave_budget=0.5, second_max_len=9000, wave_reps=10,
                 # float32 depth, and a capacity factor at which every expert's
                 # capacity is the prompt's length
                 fp32_layers=2, fp32_capacity_factor=16.0,
                 cli=["--arch", "qwen2-moe-a2.7b"] + SLOT_SSM["cli"])


def hold_calls_both_dtypes(torch, kname, label, calls, kernel, plain, errs):
    """Each captured call (a tuple of arguments, keywords) of a kernel
    against its plain version as the path gave it (bf16) and cast to
    float32, under ``TOL``; the largest error per dtype into ``errs``."""
    for i, (args, kw) in enumerate(calls):
        for dt_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dt_name)
            a = [x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point() else x
                 for x in args]
            err = hold(torch, kname, f"{label} call {i} {dt_name} "
                       + " ".join(f"{tuple(x.shape)}" for x in a if isinstance(x, torch.Tensor)),
                       lambda: kernel(*a, **kw), lambda: plain(*a, **kw), TOL[dt_name])
            errs[kname, dt_name] = max(errs.get((kname, dt_name), 0.0), err)


def moe_serve_block_plans(torch, CA, CF, stats, M, cfg, model, prompts, errs, card):
    """For each prompt length the engine served (``prompts``: length -> a
    prompt), the MoE block's plan the prefill compiled for it (traced
    again on layer 0's own input: a replay, no search), its stages and
    every loop with its chunks, layer 0's measured peak against the
    prediction (within 5%), the assignments layer 0 drops at that length's
    capacity, and both kernels on layer 0's own calls against their plain
    versions, bf16 and float32."""
    from repro_torch.models import moe as MOE

    tag = f"moe{cfg.sliding_window}"
    cfs = {key[2]: cf for key, cf in M._AC_CACHE.items()}
    check(set(cfs) == {tag}, f"prefill plans {sorted(cfs)}, want {tag}")
    cf = cfs[tag]
    p0 = M._index_tree(model["blocks"], 0)
    E, k = cfg.n_experts_padded, cfg.experts_per_token
    out = {}
    for S, prompt in prompts.items():
        h0 = M.embed_inputs(cfg, model, {"tokens": torch.tensor([prompt], device="cuda")})[0]
        served = cf._compiled[cf._shape_key((p0, h0))].result
        before = stats.snapshot()
        planned = cf.trace(p0, h0).search()
        searched = stats.delta(before)["search_passes"]
        loops = all_loops(planned)
        pred, stages, budget_bytes = served.final_peak, len(served.plan), planned.budget_bytes
        check(len(planned.plan.stages) == stages and planned.final_peak == pred,
              f"moe block S={S}: traced again, {len(planned.plan.stages)} stages and"
              f" {planned.final_peak} B; served {stages} and {pred} B")
        del planned
        with torch.no_grad():
            cf(p0, h0)
            _, peak, ms = measure_forward(torch, cf, (p0, h0))
        comp, ffn = [], []
        masked = capture_calls(torch, CA, "masked_attention", lambda: comp.extend(
            capture_calls(torch, CA, "computed_attention", lambda: ffn.extend(
                capture_ffn_calls(torch, CF, lambda: cf(p0, h0))))))
        chunks = {kind: sum(n for kinds, _, n in loops if kind in kinds)
                  for kind in ("attention", "swiglu")}
        cap = MOE.capacity(cfg, S)
        idx = moe_layer0_routes(torch, M, cfg, p0, h0, window=cfg.sliding_window)
        counts = torch.bincount(idx.flatten(), minlength=E)
        dropped, over = int((counts - cap).clamp(min=0).sum()), int((counts > cap).sum())
        print(f"[moe-serve] block plan S={S} budget {cfg.autochunk_budget} (layer 0's own"
              f" input; traced again: {searched} search passes): {stages} stages, loops "
              + ", ".join(f"{'+'.join(kinds)} {n} chunks of {c}" for kinds, c, n in loops)
              + f"; layer 0 activation peak {peak} B against predicted {pred} B"
              f" ({peak / pred:.4f}x), budget {budget_bytes} B; {ms:.2f} ms; layer-0 calls"
              f" computed_attention {len(comp)}, masked_attention {len(masked)}, chunked_ffn"
              f" {len(ffn)}; capacity {cap}: {dropped} of {S * k} assignments dropped"
              f" ({over} experts over capacity); {card}")
        check(abs(peak - pred) <= 0.05 * pred,
              f"moe block S={S}: peak {peak} B not within 5% of the predicted {pred} B")
        check(len(comp) + len(masked) == chunks["attention"] and len(ffn) == chunks["swiglu"],
              f"moe block S={S}: calls {len(comp)} + {len(masked)} / {len(ffn)}, plan {loops}")
        check(int(counts[cfg.n_experts:].sum()) == 0, "a padding expert was routed to")
        for kname, kcalls in (("computed_attention", comp), ("masked_attention", masked)):
            hold_calls_both_dtypes(torch, kname, f"moe-serve prefill S={S} layer 0", kcalls,
                                   getattr(CA, kname), getattr(CA, f"{kname}_plain"), errs)
        hold_calls_both_dtypes(torch, "chunked_ffn", f"moe-serve prefill S={S} layer 0",
                               [(c, {}) for c in ffn], CF.chunked_ffn, CF.chunked_ffn_plain,
                               errs)
        out[S] = dict(stages=stages, loops=[dict(kinds=list(kk), chunk=c, chunks=n)
                                            for kk, c, n in loops],
                      chunks=chunks, pred_peak=pred, peak=peak, ms=ms, budget_bytes=budget_bytes,
                      capacity=cap, dropped=dropped, experts_over_capacity=over,
                      kernel_calls={"computed_attention": len(comp),
                                    "masked_attention": len(masked), "chunked_ffn": len(ffn)})
        del h0, comp, masked, ffn
        torch.cuda.empty_cache()
    return out


def moe_wave_fp32(torch, M, cfg, model, cache, toks, pos):
    """The plain decode wave of a MoE model (MLA or GQA attention) in
    float32 from its bf16 weights and cache: a float32 copy of the cache,
    each layer's weights widened as it runs.  Of a MoE layer's routed
    experts only those its rows pick are widened (deepseek-v3's 256 are 45
    GB a layer in float32): a wave routes one token a row, each row a group
    of its own, so its top-k distinct experts fit the capacity of 8 and the
    experts no row picks add nothing."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE

    c32, k, window = cfg.with_(dtype="float32"), cfg.first_k_dense, cfg.sliding_window

    def wide(tree):
        tree = tree if isinstance(tree, dict) else M._index_tree(tree)
        return torch.utils._pytree.tree_map(lambda t: t.float(), tree)

    cache32 = torch.utils._pytree.tree_map(lambda t: t.to(torch.float32, copy=True), cache)
    with torch.no_grad():
        h = L.embed(c32, wide(model["embed"]), toks[:, None])
        for i in range(cfg.n_layers):
            layer, c = model.layer_params(i), M._layer_cache(cache32, i)
            if i < k:
                h = M.dense_block_decode(c32, wide(layer), h, c, pos, window=window)
                continue
            p = {name: wide(layer[name]) for name in ("ln1", "ln2", "attn")}
            x = M.attn_block_decode(c32, p, h, c, pos, window=window)
            hn = L.apply_norm(c32, x, p["ln2"])[:, 0]                     # (B, d)
            m = layer["moe"]
            idx, gates, _ = MOE.route(c32, hn, m["router"].float())        # (B, k)
            up = torch.einsum("bd,bkdf->bkf", hn, m["w_up"][idx].float())
            u, g = torch.chunk(up, 2, dim=-1)
            out = torch.einsum("bkf,bkfd->bkd", u * F.silu(g), m["w_down"][idx].float())
            ff = (out * gates[..., None]).sum(dim=1)
            if cfg.n_shared_experts:
                ff = ff + L.mlp(c32, wide(m["shared"]), hn, act="swiglu")
            h = x + ff[:, None]
        h = L.apply_norm(c32, h, wide(model["final_norm"]))
        return L.unembed(c32, wide(model["embed"]), h)[:, 0]


def run_moe_serve(torch, CA, CF, stats, M, flush, card):
    """qwen2-moe-a2.7b at full width and depth, bf16, stacked (the form the
    JAX package serves), through ``ServeEngine``: 2 slots, three requests
    (the first across the ring's wrap, the third in the slot the second
    frees), each prefill per block under budget 0.04 (attention on
    ``computed_attention``, the shared expert on ``chunked_ffn``), the
    launch counts zeroed just before serving and read just after; the block
    plans, peaks and kernels on layer 0's own calls; the plain versions
    swapped in; the compiled and the plain wave against a float32 wave
    (the compiled no further than 1.5x the plain), both timed, and the
    compiled one reconfigured inside its bucket; float32 at 2 layers
    against the forward; the CLI at reduced size."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Request, ServeEngine

    run = MOE_SERVE
    cfg = get_config(run["arch"])                  # bf16, 24 layers, stacked, window 8192
    cfg_ac = cfg.with_(autochunk_budget=run["budget"])
    L, B = cfg.n_layers, run["max_batch"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(run["seed"]),
                          device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    wb = moe_weight_bytes(model)
    M._AC_CACHE.clear()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg_ac, model, max_batch=B, max_len=run["max_len"], device="cuda")
    build_s = time.perf_counter() - t0
    exec_len = engine.exec_len
    width = M.cache_width(cfg, exec_len)
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in torch.utils._pytree.tree_leaves(engine.cache))
    want_kv = B * width * L * 2 * cfg.n_kv_heads * cfg.hd * 2
    print(f"[moe-serve] qwen2-moe-a2.7b bf16 stacked: weights {wb['total']} B built on the card"
          f" in {init_s:.2f}s; engine built in {build_s:.2f}s: {B} slots, max_len"
          f" {run['max_len']}, exec_len {engine.exec_len}, ring width {width}, cache"
          f" {kv_bytes} B (the configuration's {B} x {width} x {L} layers x (K, V) x"
          f" {cfg.n_kv_heads} x {cfg.hd} x 2 B = {want_kv} B; moe_layers"
          f" {tuple(engine.cache['moe_layers']['k'].shape)})")
    check(wb["total"] == 30_299_852_800, f"moe weights {wb['total']} B")
    check(engine.exec_len == 16384 and width == cfg.sliding_window and kv_bytes == want_kv,
          f"moe slot cache: exec_len {engine.exec_len}, width {width}, {kv_bytes} B")

    reqs = make_requests(Request, cfg.vocab_size, run["seed"], run["prompts"], run["max_new"])
    torch.cuda.synchronize()
    CA.computed_attention.launches = CA.masked_attention.launches = 0
    CF.chunked_ffn.launches = 0
    before = stats.snapshot()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"computed_attention": CA.computed_attention.launches,
                "masked_attention": CA.masked_attention.launches,
                "chunked_ffn": CF.chunked_ffn.launches}
    d = stats.delta(before)
    toks = sum(len(r.generated) for r in reqs)
    max_new = run["max_new"]
    check(all(r.done and len(r.generated) == m for r, m in zip(reqs, max_new)),
          "moe serving: a request did not finish with its new tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "moe serving: a token outside the vocabulary")
    waves = engine.n_decode_steps
    check(waves == max(max_new[0] - 1, max_new[1] - 1 + max_new[2] - 1),
          f"moe serving: {waves} decode waves")
    ttft = {r.rid: r.ttft_s for r in reqs}
    print(f"[moe-serve] served {len(reqs)} requests (prompts {run['prompts']}, new {max_new})"
          f" on {B} slots, prefill per block at budget {run['budget']}: {toks} tokens in"
          f" {wall:.3f}s = {toks / wall:.1f} tok/s, {waves} decode waves; TTFT"
          f" {', '.join(f'rid {k} {v:.3f}s' for k, v in ttft.items())}; block compiles"
          f" {d['search_passes']} search passes; {card}")

    errs = {}
    first = {}
    for r in reqs:
        first.setdefault(len(r.prompt), r.prompt)
    plans = moe_serve_block_plans(torch, CA, CF, stats, M, cfg_ac, model, first, errs, card)
    want_attn = sum(L * plans[len(r.prompt)]["chunks"]["attention"] for r in reqs)
    want_ffn = sum(L * plans[len(r.prompt)]["chunks"]["swiglu"] for r in reqs)
    print(f"[moe-serve] launches while serving: computed_attention"
          f" {launches['computed_attention']}, masked_attention {launches['masked_attention']}"
          f" (together = sum over the 3 prefills of {L} layers x attention chunks ="
          f" {want_attn}), chunked_ffn {launches['chunked_ffn']} (= {L} x SwiGLU chunks ="
          f" {want_ffn})")
    check(launches["computed_attention"] + launches["masked_attention"] == want_attn
          and launches["computed_attention"] > 0 and launches["chunked_ffn"] == want_ffn > 0,
          f"moe-serve launches {launches}: attention want {want_attn}, ffn want {want_ffn}")

    # the same requests with the plain versions swapped in (information)
    plain_reqs = [Request(rid=100 + r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                  for r in reqs]
    restore = swap_plain(CA, CF)
    try:
        for r in plain_reqs:
            engine.submit(r)
        engine.run()
    finally:
        restore()
    same = sum(a == b for r, rp in zip(reqs, plain_reqs) for a, b in zip(r.generated, rp.generated))
    print(f"[moe-serve] the same requests with the plain versions swapped in: {same} of {toks}"
          f" tokens equal to the kernels'")

    # the compiled wave (budget 0.5) against the plain one, on the same
    # cache, next tokens and positions: slot 0 ends holding rid 0, slot 1
    # rid 2 (admitted into the slot rid 1 freed)
    before = stats.snapshot()
    t0 = time.perf_counter()
    e2 = ServeEngine(cfg_ac, model, max_batch=B, max_len=run["max_len"],
                     autochunk_budget=run["wave_budget"], device="cuda")
    wave_build = time.perf_counter() - t0
    dw = stats.delta(before)
    res = e2.autochunk_result
    for full, mine in zip(torch.utils._pytree.tree_leaves(e2.cache),
                          torch.utils._pytree.tree_leaves(engine.cache)):
        full.copy_(mine)
    last = (plain_reqs[0], plain_reqs[2])
    toks_w = torch.tensor([r.generated[-1] for r in last], device="cuda")
    pos_w = torch.tensor([len(r.prompt) + len(r.generated) for r in last], device="cuda")
    print(f"[moe-serve] compiled wave: built in {wave_build:.2f}s ({dw['trace_calls']} trace,"
          f" {dw['search_passes']} search passes), {len(res.plan)} stages, predicted peak"
          f" {res.baseline_peak} -> {res.final_peak} B (budget {res.budget_bytes} B);"
          f" dispatch hits {dw['kernel_dispatch_hits']}, misses {dw['kernel_dispatch_misses']}")
    # both bf16 waves against the plain wave in float32 from the same cache
    # (the cache and each layer's weights widened in turn): the compiled
    # wave's products sum in other orders and each of the 24 layers rounds
    # its output to bf16, so the two bf16 waves part by more than one
    # kernel's bf16 limit; the compiled one must be no further from float32
    # than 1.5x the plain one (the per-block rule)
    with torch.no_grad():
        lg_ref = moe_wave_fp32(torch, M, cfg, model, e2.cache, toks_w, pos_w)[:, :cfg.vocab_size]
        lg_plain = engine._decode_wave(engine.cache, toks_w, pos_w)[:, :cfg.vocab_size]
        lg_comp = e2._decode_wave(e2.cache, toks_w, pos_w)[:, :cfg.vocab_size]
    atol, rtol = TOL["bfloat16"]
    diff = (lg_comp.float() - lg_plain.float()).abs()
    wave_err = float(diff.max())
    wave_share = float((diff / (atol + rtol * lg_plain.float().abs())).max())
    d_comp = float((lg_comp.float() - lg_ref).abs().max())
    d_plain = float((lg_plain.float() - lg_ref).abs().max())
    print(f"[moe-serve] first compiled wave against the plain one, bf16 logits: max_abs_err"
          f" {wave_err:.3e} (max|plain| {float(lg_plain.float().abs().max()):.3f}), {wave_share:.3f}"
          f" of one kernel's bf16 limit {atol:g} + {rtol:g}|want|; from the float32 wave:"
          f" compiled {d_comp:.3e}, plain {d_plain:.3e} (limit 1.5x the plain's); argmax"
          f" equal to the float32 wave's in {int((lg_comp.argmax(-1) == lg_ref.argmax(-1)).sum())}"
          f" (compiled) and {int((lg_plain.argmax(-1) == lg_ref.argmax(-1)).sum())} (plain) of"
          f" {B} rows")
    check(bool(torch.isfinite(lg_comp).all()) and d_comp <= 1.5 * d_plain,
          f"compiled moe wave {d_comp} from float32, plain {d_plain}")
    del lg_ref
    torch.cuda.empty_cache()
    # a wave reads every weight but the embedding table once, and both rows'
    # rings: every routed expert runs on its (B, E, 8, d) buffer
    wave_bytes = (wb["total"] - model["embed"]["embedding"].numel() * 2 + kv_bytes)
    with torch.no_grad():
        ms_plain = time_ms(torch, lambda: engine._decode_wave(engine.cache, toks_w, pos_w),
                           flush, reps=run["wave_reps"])
        ms_comp = time_ms(torch, lambda: e2._decode_wave(e2.cache, toks_w, pos_w), flush,
                          reps=run["wave_reps"])
    wave_bound = wave_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[moe-serve] decode wave {ms_comp:.3f} ms compiled, {ms_plain:.3f} ms plain"
          f" (CUDA-event medians of {run['wave_reps']}, {B} rows of {width} cache slots, {L}"
          f" layers); bound {wave_bound:.3f} ms (bytes: {wave_bytes} B of weights and rings);"
          f" {card}")
    del engine
    torch.cuda.empty_cache()
    before = stats.snapshot()
    compiles = e2.exec_stats["wave_compiles"]
    e2.reconfigure(max_len=run["second_max_len"])
    dr = stats.delta(before)
    print(f"[moe-serve] reconfigure(max_len={run['second_max_len']}): exec_len {e2.exec_len},"
          f" bucket_exec_hits {dr['bucket_exec_hits']}, trace_calls {dr['trace_calls']},"
          f" search_passes {dr['search_passes']}, wave_compiles"
          f" {e2.exec_stats['wave_compiles']} (was {compiles})")
    check(e2.exec_len == 16384 and dr["bucket_exec_hits"] == 1 and dr["trace_calls"] == 0
          and dr["search_passes"] == 0 and e2.exec_stats["wave_compiles"] == compiles,
          f"moe reconfigure inside the bucket: {dr}")
    del e2, model
    M._AC_CACHE.clear()
    torch.cuda.empty_cache()

    # float32 at 2 layers, capacity factor 16; slot 0 ends holding rid 0,
    # slot 1 rid 2
    cfg32 = cfg.with_(dtype="float32", n_layers=run["fp32_layers"],
                      capacity_factor=run["fp32_capacity_factor"])
    from repro_torch.models import moe as MOE
    longest = run["prompts"][0] + run["max_new"][0]
    check(all(MOE.capacity(cfg32, n) >= n for n in (1,) + run["prompts"] + (longest,)),
          "fp32 moe: an expert's capacity below the length")
    fp32 = served_fp32_logits(
        torch, M, ServeEngine, Request, cfg32, run, 15, "moe-serve", (0, 2), card,
        why=f" (capacity factor {run['fp32_capacity_factor']:g}: each expert's capacity is at"
        f" least the length, and top-{cfg.experts_per_token} picks distinct experts, so no"
        " expert overflows and the served logits must equal the forward's)")
    cli = moe_serve_cli(torch)
    return dict(weight_bytes=wb["total"], init_s=init_s, build_s=build_s,
                exec_len=exec_len, ring_width=width, cache_bytes=kv_bytes,
                wall_s=wall, tokens=toks, tok_s=toks / wall, decode_waves=waves, ttft_s=ttft,
                launches=launches, plans={str(k): v for k, v in plans.items()},
                plain_swapped_equal=same, wave_err=wave_err, wave_share_of_tol=wave_share,
                wave_err_from_fp32=d_comp, plain_wave_err_from_fp32=d_plain,
                wave_ms=ms_comp, plain_wave_ms=ms_plain, wave_bound_ms=wave_bound,
                wave_stages=len(res.plan), wave_build_s=wave_build, fp32=fp32, cli=cli,
                errs=errs)


def moe_serve_cli(torch):
    """``serve.main --arch qwen2-moe-a2.7b --local`` on the card: the
    fixed-slot engine serves the reduced model; its ``[serve]`` lines."""
    import contextlib
    import io

    from repro_torch.launch import serve

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.main(MOE_SERVE["cli"])
    lines = [ln for ln in text.getvalue().splitlines() if ln.startswith("[serve]")]
    for ln in lines:
        print(f"[moe-serve] CLI qwen2-moe-a2.7b --local: {ln}")
    check(any(re.match(r"\[serve\] 3 requests, 24 tokens ", ln) for ln in lines),
          "the serving CLI did not serve qwen2-moe-a2.7b")
    torch.cuda.empty_cache()
    return lines


# ---------------------------------------------------------------------------
# MLA: deepseek-v3-671b's dense prefix and two MoE layers, per block
# ---------------------------------------------------------------------------

MLA_RUN = dict(arch="deepseek-v3-671b",
               # the 3 dense layers and 2 MoE layers (plus the MTP head's
               # params): 61 layers hold 1.3 TB of bf16 weights
               n_layers=5, weight_bytes=54_616_616_960,
               seq_len=8192, short_len=2048, seed=16,
               # the loosest round ratio whose dense-prefix plan chunks the
               # MLA (planned on meta at S 8192: at 0.04 and 0.02 the scores'
               # head loop alone meets the budget and the MLP stays whole)
               budget=0.01,
               # float32 at one dense and one MoE layer
               fp32_seed=17)


def set_allocator(torch, settings):
    """The caching allocator's settings (``PYTORCH_CUDA_ALLOC_CONF`` syntax)
    for the allocations from here on."""
    fn = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (fn or torch.cuda.memory._set_allocator_settings)(settings)


def labelled_loops(planned):
    """[(kind, rows or heads per chunk, trips)] of every chunk loop of a
    planned block: its dispatch kinds, ``scores`` for a generic loop whose
    body holds the softmax (MLA's summed scores), else ``generic``."""
    from repro_torch.core.graph import op_name
    from repro_torch.core.lowering import is_chunk_loop

    out = []
    for n in planned.graph.nodes:
        if not is_chunk_loop(n):
            continue
        kinds = "+".join(d.kind for d in n.params["dispatches"])
        if not kinds:
            body = {op_name(op.node) for op in n.params["body"]}
            kinds = "scores" if "_softmax" in body else "generic"
        out.append((kinds, n.params["c"], n.params["n_iters"]))
    return out


def mla_weight_bytes(model):
    """Bytes of deepseek-v3's weights by part: a dense block (its MLA
    attention and MLP), a MoE block (routed experts, shared expert,
    router), the embedding and head, the MTP head and the whole model."""
    nb = param_bytes
    dense, moe = model.layer_params(0), model.layer_params(model.cfg.first_k_dense)
    m = moe["moe"]
    return dict(dense_block=nb(dense), attention=nb(dense["attn"]), mlp=nb(dense["mlp"]),
                moe_block=nb(moe), routed_up=nb(m["w_up"]), routed_down=nb(m["w_down"]),
                shared=nb(m["shared"]), router=nb(m["router"]), embedding=nb(model["embed"]),
                mtp_proj=nb(model["mtp_proj"]), mtp_block=nb(model["mtp_block"]),
                total=nb(model))


def mla_forward_fp32(torch, M, cfg, model, batch, window):
    """The unbudgeted forward in float32 from the bf16 model, which it
    consumes: each layer's weights are widened on the card in place as the
    layer runs and freed after it, so the float32 model (109 GB at 5
    layers) never sits whole on the card.  The later MoE layers' routed
    experts wait on the host meanwhile: one MoE layer's float32 experts
    (45 GB) do not fit beside another's bf16 ones and the rest."""
    from repro_torch.models import layers as L

    c32, k = cfg.with_(dtype="float32"), cfg.first_k_dense
    for i in range(k + 1, cfg.n_layers):
        m = model.layer_params(i)["moe"]
        for name in ("w_up", "w_down"):
            m[name].data = m[name].data.cpu()

    def wide(tree):
        return torch.utils._pytree.tree_map(lambda t: t.float(), M._index_tree(tree))

    with torch.no_grad():
        h = L.embed(c32, wide(model["embed"]), batch["tokens"])
        for i in range(cfg.n_layers):
            layer = model.layer_params(i)
            for t in layer.parameters():
                t.data = t.data.cuda().float()
            p = M._index_tree(layer)
            h = (M.dense_block_full(c32, p, h, window=window) if i < k
                 else M.moe_block_full(c32, p, h, window=window)[0])
            for t in layer.parameters():
                t.data = t.data.new_empty(0)
            del p
        h = L.apply_norm(c32, h, wide(model["final_norm"]))
        return L.unembed(c32, wide(model["embed"]), h)


def mla_block_plans(torch, M, cfg, model, cfs, h0, card, label="[block] mla"):
    """Each block plan compiled at ``h0``'s length, traced again on its
    first layer's own input (a replay: no search): stages, every loop with
    its chunks, the predicted unchunked and chunked peaks, the values live
    at the chunked peak, and the first layer's measured chunked peak
    against the prediction (within 5%).  The dense prefix's first layer is
    layer 0, the MoE block's layer ``first_k_dense``, whose input the
    dense plan's replays make.  Returns the plans and that input."""
    from repro_torch.core import stats

    k, W = cfg.first_k_dense, cfg.sliding_window
    out, x = {}, h0
    for tag, layer in ((f"densepre{W}", 0), (f"moe{W}", k)):
        cf, p = cfs[tag], M._index_tree(model.layer_params(layer))
        if layer:
            with torch.no_grad():
                for i in range(k):
                    x = cfs[f"densepre{W}"](M._index_tree(model.layer_params(i)), x)
        r = cf._compiled[cf._shape_key((p, x))].result
        before = stats.snapshot()
        planned = cf.trace(p, x).search()
        check(stats.delta(before)["search_passes"] == 0, f"{tag}: the replay searched")
        loops, live = labelled_loops(planned), live_at_peak(planned)
        del planned
        with torch.no_grad():
            cf(p, x)
            _, peak, ms = measure_forward(torch, cf, (p, x))
        print(f"{label} {tag}: one compile (host seconds trace {r.trace_s:.2f}, search"
              f" {r.search_s:.2f}, compile {r.elapsed_s - r.trace_s - r.search_s:.2f}),"
              f" {len(r.plan)} stages; predicted block peak unchunked {r.baseline_peak} B (not"
              f" run: beside the weights it does not fit the card) -> chunked {r.final_peak} B"
              f" ({1 - r.final_peak / r.baseline_peak:.1%} less; budget {r.budget_bytes} B,"
              f" {'within' if r.final_peak <= r.budget_bytes else 'above'} it)")
        for kind, c, n in loops:
            print(f"{label} {tag} loop {kind}: {n} chunks of {c}"
                  + (" (the MLA scores: q_nope k_nope^T + q_rope k_rope^T, generic)"
                     if kind == "scores" else ""))
        print(f"{label} {tag} values live at the predicted peak: "
              + ", ".join(f"{op} {tuple(shape)} {b} B" for b, op, shape in live))
        print(f"{label} {tag} layer {layer} activation peak: chunked {peak} B (predicted"
              f" {r.final_peak} B, {peak / r.final_peak:.4f}x); {ms:.2f} ms; {card}")
        check(abs(peak - r.final_peak) <= 0.05 * r.final_peak,
              f"mla {tag} chunked peak {peak} B is not within 5% of the predicted"
              f" {r.final_peak} B")
        check(not any("attention" in kind for kind, _, _ in loops),
              f"mla {tag}: an attention kernel dispatched on the summed scores: {loops}")
        check(any(kind == "scores" for kind, _, _ in loops),
              f"mla {tag}: the scores are not chunked: {loops}")
        out[tag] = dict(layer=layer, stages=len(r.plan), trace_s=r.trace_s, search_s=r.search_s,
                        pred_unchunked=r.baseline_peak, pred_chunked=r.final_peak,
                        budget_bytes=r.budget_bytes, peak=peak, ms=ms,
                        loops=[dict(kind=kk, chunk=c, chunks=n) for kk, c, n in loops],
                        swiglu_chunks=sum(n for kk, _, n in loops if kk == "swiglu"),
                        live_at_peak=[list(t) for t in live])
    return out, x


def run_mla_forward(torch, F, CA, CF, stats, M, flush, card):
    """deepseek-v3-671b at full width, its depth cut to the 3 dense layers
    and 2 MoE layers (plus the MTP head's params), bf16, random weights,
    the list form, the earlier phases' weights freed first.  At S 8192 the
    unchunked block cannot run beside its weights, so the forward runs per
    block at budget 0.01 (one plan for the dense prefix, ``densepre8192``,
    one for the MoE blocks, ``moe8192``, each compiled at its first layer
    and replayed for the others), counts zeroed just before and read just
    after: ``chunked_ffn`` launched for every SwiGLU chunk of the plans and
    no attention kernel (MLA's scores are a sum of two products).  The
    plans and first-layer peaks (within 5%), the first MoE layer's routing
    at capacity 320, ``chunked_ffn`` on layer 0's own calls (f 18432) and
    on the first MoE layer's shared expert (f 2048) against its plain
    version (bf16 and f32) and its time at both shapes.  At S 2048 the
    forward unbudgeted and per block, bf16 against a float32 forward of
    the same weights (per block no further than 1.5x unbudgeted), and the
    MTP head once.  Then float32 at 2 layers (one dense, one MoE): per
    block within 1e-3 of unbudgeted in logits, 1e-6 in aux."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import ChunkConfig, autochunk
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE

    run = MLA_RUN
    t_phase = time.perf_counter()
    # each MoE layer's routed w_up is drawn as one 30 GB f32 tensor; in
    # fixed segments the first layer's freed draw is split by the smaller
    # weights after it and the second's finds no room, so this phase
    # allocates in expandable segments.  A collection first frees what any
    # reference cycle of an earlier phase still holds on the card (the
    # engines hold none); the bytes it frees are printed
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    set_allocator(torch, "expandable_segments:True")
    print(f"[mla] on the card before the weights: {torch.cuda.memory_allocated()} B allocated;"
          f" the garbage collection freed {held - torch.cuda.memory_allocated()} B")
    cfg = get_config(run["arch"]).with_(scan_layers=False, n_layers=run["n_layers"])
    cfg_ac = cfg.with_(autochunk_budget=run["budget"])
    W, S, n_layers, k = cfg.sliding_window, run["seq_len"], cfg.n_layers, cfg.first_k_dense
    V, E = cfg.vocab_size, cfg.n_experts_padded
    dtag, mtag = f"densepre{W}", f"moe{W}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(run["seed"]),
                          device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    wb = mla_weight_bytes(model)
    print(f"[mla] deepseek-v3-671b bf16 d={cfg.d_model} H={cfg.n_heads} q_lora"
          f" {cfg.q_lora_rank} kv_lora {cfg.kv_lora_rank} qk_nope {cfg.qk_nope_dim} qk_rope"
          f" {cfg.qk_rope_dim} v {cfg.v_head_dim}; {k} dense layers (f {cfg.d_ff}) and"
          f" {n_layers - k} MoE layers ({cfg.n_experts} experts top-{cfg.experts_per_token},"
          f" sigmoid routing, f {cfg.moe_d_ff}, {cfg.n_shared_experts} shared), vocab {V},"
          f" MTP head: weights built on the card in {build_s:.2f}s, {wb['total']} B (dense"
          f" block {wb['dense_block']} B: MLA attention {wb['attention']} B, MLP {wb['mlp']}"
          f" B; MoE block {wb['moe_block']} B: routed w_up {wb['routed_up']} B, w_down"
          f" {wb['routed_down']} B, shared {wb['shared']} B, router {wb['router']} B;"
          f" embedding and head {wb['embedding']} B; MTP proj {wb['mtp_proj']} B, block"
          f" {wb['mtp_block']} B)")
    check(wb["total"] == run["weight_bytes"], f"mla weights {wb['total']} B,"
          f" want {run['weight_bytes']}")
    check((wb["dense_block"], wb["moe_block"], wb["embedding"], wb["mtp_proj"])
          == (1_166_966_784, 23_018_242_048, 3_706_716_160, 205_520_896),
          f"mla weight parts {wb}")
    rng = np.random.default_rng(run["seed"])
    batch = {"tokens": torch.tensor(rng.integers(0, V, (1, S)), device="cuda")}

    def per_block():
        return M.forward(cfg_ac, model, batch, window=W)

    # the first per-block forward: one search per block kind, then replays
    M._AC_CACHE.clear()
    before = stats.snapshot()
    t0 = time.perf_counter()
    with torch.no_grad():
        y1, aux1 = per_block()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    d = stats.delta(before)
    del y1
    cfs = {key[2]: cf for key, cf in M._AC_CACHE.items()}
    check(set(cfs) == {dtag, mtag}, f"mla plans {sorted(cfs)}")
    check(cfs[dtag].counters["compiles"] == 1 and cfs[mtag].counters["compiles"] == 1
          and cfs[dtag].counters["shape_hits"] == k - 1
          and cfs[mtag].counters["shape_hits"] == n_layers - k - 1,
          f"first forward: {cfs[dtag].stats()}, {cfs[mtag].stats()}")
    print(f"[block] mla: first per-block forward {first_s:.2f}s ({d['search_passes']} search"
          f" passes); dispatch hits {d['kernel_dispatch_hits']} (computed mask"
          f" {d['kernel_dispatch_computed_mask']}), misses {d['kernel_dispatch_misses']}")
    check(d["kernel_dispatch_computed_mask"] == 0, "an attention kernel matched MLA")
    h0 = M.embed_inputs(cfg, model, batch)[0]
    plans, hk = mla_block_plans(torch, M, cfg, model, cfs, h0, card)
    pk = M._index_tree(model.layer_params(k))

    # the first MoE layer's routing at capacity, and its shared expert's
    # input, from its attention half compiled under the same budget
    attn_half = autochunk(lambda p, x: M.attn_apply_full(cfg, p, x, None, window=W, causal=True),
                          ChunkConfig.from_scalar(run["budget"], weight_argnums=(0,),
                                                  dim_blocklist=(0,)))
    with torch.no_grad():
        hn = L.apply_norm(cfg, attn_half(pk, hk), pk["ln2"])
        idx = MOE.route(cfg, hn.reshape(-1, cfg.d_model), pk["moe"]["router"])[0]
    del attn_half
    cap = MOE.capacity(cfg, S)
    counts = torch.bincount(idx.flatten(), minlength=E)
    dropped, over = int((counts - cap).clamp(min=0).sum()), int((counts > cap).sum())
    print(f"[mla] layer {k} (the first MoE layer) routing at S={S}: capacity {cap} a expert;"
          f" assignments per expert min {int(counts.min())} max {int(counts.max())}; {over}"
          f" experts over capacity, {dropped} of {S * cfg.experts_per_token} assignments"
          f" dropped")
    check(cap == 320, f"capacity {cap}, want 320")

    # chunked_ffn on layer 0's own calls and on the shared expert's
    errs = {}
    p0 = M._index_tree(model.layer_params(0))
    calls = capture_ffn_calls(torch, CF, lambda: cfs[dtag](p0, h0))
    check(len(calls) == plans[dtag]["swiglu_chunks"] > 0,
          f"{len(calls)} chunked_ffn calls in layer 0, plan {plans[dtag]['loops']}")
    hold_calls_both_dtypes(torch, "chunked_ffn", "mla densepre layer 0",
                           [(c, {}) for c in calls], CF.chunked_ffn, CF.chunked_ffn_plain, errs)
    dense_rows = calls[0][0].shape[0]
    del calls
    calls = capture_ffn_calls(torch, CF, lambda: cfs[mtag](pk, hk))
    check(len(calls) == plans[mtag]["swiglu_chunks"],
          f"{len(calls)} chunked_ffn calls in layer {k}, plan {plans[mtag]['loops']}")
    sh = pk["moe"]["shared"]
    f_sh = sh["w_out"].shape[0]
    label = f"mla shared expert layer {k}"
    if not calls:
        # the plan leaves the shared expert's SwiGLU whole (an eager mlp):
        # the kernel held on that one call as the wrapper would take it,
        # the layer's own normed input against the shared expert's weights
        calls = [(hn.reshape(-1, cfg.d_model), sh["w_in"][:, f_sh:], sh["w_in"][:, :f_sh],
                  sh["w_out"])]
        label += " (unchunked in the plan; its whole call)"
    hold_calls_both_dtypes(torch, "chunked_ffn", label, [(c, {}) for c in calls],
                           CF.chunked_ffn, CF.chunked_ffn_plain, errs)
    shared_rows = calls[0][0].shape[0]
    del calls, hn, idx

    # the whole forward per block, counts zeroed just before, read just after
    hits = {tag: cf.counters["shape_hits"] for tag, cf in cfs.items()}
    before = stats.snapshot()
    CA.computed_attention.launches = CA.masked_attention.launches = 0
    CF.chunked_ffn.launches = 0
    with torch.no_grad():
        (y1, aux1), peak1, ms1 = measure_forward(torch, per_block, ())
    n_ffn, n_attn = CF.chunked_ffn.launches, CA.computed_attention.launches
    n_masked = CA.masked_attention.launches
    d = stats.delta(before)
    want_ffn = k * plans[dtag]["swiglu_chunks"] + (n_layers - k) * plans[mtag]["swiglu_chunks"]
    check(d["search_passes"] == 0 and cfs[dtag].counters["shape_hits"] - hits[dtag] == k
          and cfs[mtag].counters["shape_hits"] - hits[mtag] == n_layers - k,
          f"second forward: {d['search_passes']} search passes")
    check(n_ffn == want_ffn > 0, f"chunked_ffn launched {n_ffn} times, want {want_ffn}")
    check(n_attn == 0 and n_masked == 0,
          f"attention kernels launched {n_attn} + {n_masked} times on MLA")
    check(bool(torch.isfinite(y1[..., :V]).all()), "non-finite mla logits")
    check(bool(torch.isfinite(aux1)) and float(aux1) > 0, f"mla aux loss {float(aux1)}")
    print(f"[forward] deepseek-v3-671b L={n_layers} S={S} per block at budget {run['budget']}:"
          f" whole-forward peak {peak1} B beside {wb['total']} B of weights, time {ms1:.2f} ms;"
          f" chunked_ffn launches {n_ffn} = {k} x {plans[dtag]['swiglu_chunks']} +"
          f" {n_layers - k} x {plans[mtag]['swiglu_chunks']} SwiGLU chunks; computed_attention"
          f" {n_attn}, masked_attention {n_masked} (MLA's scores: generic loops); aux loss"
          f" {float(aux1):.6f}; the unchunked forward does not run (predicted block peaks"
          f" {plans[dtag]['pred_unchunked']} / {plans[mtag]['pred_unchunked']} B); {card}")
    del y1, h0, hk, p0, pk

    # chunked_ffn's time at the new width: the dense MLP's chunk and the
    # shared expert's
    ffn_timed = {"dense": time_ffn_kernel(torch, F, CF, cfg, dense_rows, flush, card),
                 "shared": time_ffn_kernel(torch, F, CF, cfg.with_(d_ff=f_sh), shared_rows,
                                           flush, card)}

    # S 2048: unbudgeted beside per block, against a float32 forward; the
    # MTP head once
    S2 = run["short_len"]
    batch = {"tokens": torch.tensor(rng.integers(0, V, (1, S2)), device="cuda")}
    with torch.no_grad():
        (y16u, aux_u), peak_u, ms_u = measure_forward(
            torch, lambda: M.forward(cfg, model, batch, window=W), ())
        M.forward(cfg_ac, model, batch, window=W)
        (y16c, aux_c), peak_c, ms_c = measure_forward(
            torch, lambda: M.forward(cfg_ac, model, batch, window=W), ())
        h_emb = M.embed_inputs(cfg, model, batch)[0]
        mtp = M.mtp_logits(cfg, model, batch, h_emb)
    check(tuple(mtp.shape) == (1, S2 - 1, cfg.vocab_padded)
          and bool(torch.isfinite(mtp[..., :V]).all()), f"mtp logits {tuple(mtp.shape)}")
    print(f"[forward] deepseek-v3-671b L={n_layers} S={S2}: unbudgeted peak {peak_u} B,"
          f" {ms_u:.2f} ms, aux {float(aux_u):.6f}; per block peak {peak_c} B, {ms_c:.2f} ms,"
          f" aux {float(aux_c):.6f}; mtp_logits {tuple(mtp.shape)}, finite")
    del mtp, h_emb
    # the model, the S 2048 logits and the plans stay for [mla-serve] (its
    # S 2048 prefill replays these plans) and then for finish_mla_forward
    state = dict(cfg=cfg, cfg_ac=cfg_ac, model=model, batch=batch, y16u=y16u, y16c=y16c,
                 seconds=time.perf_counter() - t_phase)
    out = dict(weight_bytes=wb, build_s=build_s, seconds_first=first_s, plans=plans,
               capacity=cap, dropped_first_moe_layer=dropped, experts_over_capacity=over,
               peak=peak1, ms=ms1, chunked_ffn_launches=n_ffn, attention_launches=n_attn,
               masked_launches=n_masked, aux=float(aux1), ffn_timed=ffn_timed, errs=errs,
               short=dict(peak_unbudgeted=peak_u, ms_unbudgeted=ms_u, peak_per_block=peak_c,
                          ms_per_block=ms_c))
    print(f"[mla] bf16 part done in {state['seconds']:.1f}s")
    return out, state


def finish_mla_forward(torch, M, card, out, state):
    """The rest of ``[mla]`` after ``[mla-serve]`` served its model: the
    S 2048 bf16 logits against a float32 forward of the same weights, which
    consumes the bf16 model (per block no further than 1.5x unbudgeted),
    then float32 at 2 layers (one dense, one MoE): per block within 1e-3 of
    unbudgeted in logits, 1e-6 in aux.  Returns the 2-layer float32 model
    and its config for ``[mla-serve]``'s float32 serving."""
    import numpy as np

    run = MLA_RUN
    t_phase = time.perf_counter()
    cfg, model, batch = state.pop("cfg"), state.pop("model"), state.pop("batch")
    y16u, y16c = state.pop("y16u"), state.pop("y16c")
    W, V, S2, n_layers = cfg.sliding_window, cfg.vocab_size, run["short_len"], cfg.n_layers
    M._AC_CACHE.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    y32 = mla_forward_fp32(torch, M, cfg, model, batch, W)
    fp32_s = time.perf_counter() - t0
    err_u, err_c = max_logit_err(y16u, y32, V), max_logit_err(y16c, y32, V)
    print(f"[forward] deepseek-v3-671b bf16 L={n_layers} S={S2} against the float32 logits of"
          f" the same weights (widened layer by layer as they run, the second MoE layer's"
          f" experts from the host, {fp32_s:.2f}s):"
          f" unbudgeted max_abs_err {err_u:.3e}, per block {err_c:.3e}"
          f" ({err_c / err_u:.3f}x; limit 1.5x); {card}")
    check(err_c <= 1.5 * err_u, f"bf16 mla per-block logits stray {err_c} from float32, the"
          f" unbudgeted bf16 ones {err_u}")
    del y16u, y16c, y32, model, batch
    M._AC_CACHE.clear()
    torch.cuda.empty_cache()

    # float32 at one dense and one MoE layer: per block against unbudgeted
    cfg32 = cfg.with_(dtype="float32", n_layers=2, first_k_dense=1)
    model = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(run["fp32_seed"]),
                          device="cuda")
    batch = {"tokens": torch.tensor(np.random.default_rng(run["fp32_seed"])
                                    .integers(0, V, (1, S2)), device="cuda")}
    with torch.no_grad():
        y0, a0 = M.forward(cfg32, model, batch, window=W)
        y1, a1 = M.forward(cfg32.with_(autochunk_budget=run["budget"]), model, batch, window=W)
    err32, aerr = max_logit_err(y1, y0, V), abs(float(a1) - float(a0))
    stages = {key[2]: len(cf.autochunk_result.plan) for key, cf in M._AC_CACHE.items()}
    print(f"[forward] deepseek-v3-671b per-block fp32 L=2 (1 dense, 1 MoE) S={S2}: stages"
          f" {stages}; per-block vs unbudgeted logits max_abs_err {err32:.3e} (limit 1e-3), aux"
          f" {float(a0):.8f} vs {float(a1):.8f} (|delta| {aerr:.3e}; limit 1e-6)")
    check(err32 <= 1e-3 and aerr <= 1e-6, f"fp32 mla per-block logits {err32}, aux {aerr}")
    del y0, y1, batch
    M._AC_CACHE.clear()
    torch.cuda.empty_cache()
    phase_s = state["seconds"] + time.perf_counter() - t_phase
    print(f"[mla] phase done in {phase_s:.1f}s (the bf16 part and the float32 checks)")
    out["short"].update(bf16_vs_fp32_unchunked=err_u, bf16_vs_fp32_per_block=err_c,
                        fp32_widen_s=fp32_s)
    out.update(fp32_logits_err=err32, fp32_aux_err=aerr, fp32_stages=stages, seconds=phase_s)
    return model, cfg32


# ---------------------------------------------------------------------------
# MLA serving: deepseek-v3-671b's latent cache through the fixed-slot engine
# ---------------------------------------------------------------------------

MLA_SERVE = dict(seed=18, max_batch=2, max_len=8320,
                 # the first decodes across position 8192 (the ring's first
                 # overwrite at wave 64); the second has [mla]'s S 2048 length,
                 # so its prefill replays those plans; the third is admitted
                 # into the slot the second frees
                 prompts=(8128, 2048, 1000), max_new=(96, 32, 32),
                 wave_budget=0.5, second_max_len=9000, wave_reps=10,
                 # float32 at [mla]'s 2 layers, with a capacity factor at which
                 # an expert's capacity is at least the length (32 at top-8
                 # of 256), so no expert overflows in the forward
                 fp32_prompt=256, fp32_new=32, fp32_capacity_factor=32.0, fp32_seed=19,
                 cli=["--arch", "deepseek-v3-671b"] + SLOT_SSM["cli"])


def mla_wave_bytes(model, cache_bytes):
    """Bytes one decode wave must read: every block's weights (each MoE
    block with all its routed experts: ``moe_ffn`` runs them on their (B,
    E, 8, d) buffer), the final norm and the head, and both rows' rings;
    the embedding table is read a row at a time and the MTP head not at
    all."""
    cfg = model.cfg
    blocks = sum(param_bytes(model.layer_params(i)) for i in range(cfg.n_layers))
    return (blocks + param_bytes(model["final_norm"]) + param_bytes(model["embed"]["lm_head"])
            + cache_bytes)


def run_mla_serve(torch, CA, CF, stats, M, flush, card, state):
    """deepseek-v3-671b served through ``ServeEngine`` on the model ``[mla]``
    built (bf16, full width, 3 dense and 2 MoE layers, the list form): 2
    slots of latent rings (``ckv`` and ``kr``, 1,152 B a token a layer),
    three requests (the first across the ring's first overwrite, the
    second at ``[mla]``'s S 2048, whose prefill replays its plans, the
    third in the slot the second frees), each prefill per block at
    ``[mla]``'s budget 0.01, the launch counts zeroed just before serving
    and read just after: ``chunked_ffn`` for every dense SwiGLU chunk of
    the plans, no attention kernel.  The block plans at each prompt length
    with layer-0 peaks within 5%, ``chunked_ffn`` on the 8128-token
    prefill's layer-0 calls against its plain version, the plain versions
    swapped in, the compiled wave (budget 0.5) and the plain one against a
    float32 wave (the compiled within 1.5x the plain's distance), both
    timed beside the wave's bound by bytes, and the compiled one
    reconfigured inside its bucket."""
    from repro_torch.serving import Request, ServeEngine

    run = MLA_SERVE
    t_phase = time.perf_counter()
    cfg_ac, model = state["cfg_ac"], state["model"]
    cfg = cfg_ac.with_(autochunk_budget=None)
    L, B, k, W = cfg.n_layers, run["max_batch"], cfg.first_k_dense, cfg.sliding_window
    dtag, mtag = f"densepre{W}", f"moe{W}"
    t0 = time.perf_counter()
    engine = ServeEngine(cfg_ac, model, max_batch=B, max_len=run["max_len"], device="cuda")
    build_s = time.perf_counter() - t0
    width = M.cache_width(cfg, engine.exec_len)
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in torch.utils._pytree.tree_leaves(engine.cache))
    token_bytes = (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    kv_token_bytes = cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim) * 2
    want_kv, decompressed = B * width * L * token_bytes, B * width * L * kv_token_bytes
    print(f"[mla-serve] deepseek-v3-671b bf16, {L} layers ({k} dense, {L - k} MoE), the model"
          f" [mla] built ({param_bytes(model)} B; not built again): engine built in"
          f" {build_s:.2f}s: {B} slots, max_len {run['max_len']}, exec_len {engine.exec_len},"
          f" ring width {width}, latent cache {kv_bytes} B ({B} x {width} x {L} layers x"
          f" ({cfg.kv_lora_rank} + {cfg.qk_rope_dim}) x 2 B = {want_kv} B, {token_bytes} B a"
          f" token a layer); decompressed K/V of the same shape would take {kv_token_bytes} B a"
          f" token a layer, {decompressed} B ({decompressed / kv_bytes:.1f}x)")
    check(engine.exec_len == 16384 and width == W == 8192 and kv_bytes == want_kv
          == 94_371_840 and decompressed == 6_710_886_400,
          f"mla slot cache: exec_len {engine.exec_len}, width {width}, {kv_bytes} B")
    check(set(engine.cache["layers"][0]) == {"ckv", "kr"}, "the cache holds no latent ring")

    reqs = make_requests(Request, cfg.vocab_size, run["seed"], run["prompts"], run["max_new"])
    # search passes per prefill, read around each prefill the engine runs
    searches, prefill = {}, M.prefill

    def counted_prefill(*args, **kw):
        before = stats.snapshot()
        out = prefill(*args, **kw)
        searches[args[2]["tokens"].shape[1]] = stats.delta(before)["search_passes"]
        return out

    M.prefill = counted_prefill
    try:
        torch.cuda.synchronize()
        CA.computed_attention.launches = CA.masked_attention.launches = 0
        CF.chunked_ffn.launches = 0
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"computed_attention": CA.computed_attention.launches,
                    "masked_attention": CA.masked_attention.launches,
                    "chunked_ffn": CF.chunked_ffn.launches}
    finally:
        M.prefill = prefill
    toks = sum(len(r.generated) for r in reqs)
    max_new = run["max_new"]
    check(all(r.done and len(r.generated) == m for r, m in zip(reqs, max_new)),
          "mla serving: a request did not finish with its new tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "mla serving: a token outside the vocabulary")
    waves = engine.n_decode_steps
    check(waves == max(max_new[0] - 1, max_new[1] - 1 + max_new[2] - 1),
          f"mla serving: {waves} decode waves")
    ttft = {r.rid: r.ttft_s for r in reqs}
    print(f"[mla-serve] served {len(reqs)} requests (prompts {run['prompts']}, new {max_new}) on"
          f" {B} slots, prefill per block at budget {cfg_ac.autochunk_budget}: {toks} tokens in"
          f" {wall:.3f}s = {toks / wall:.1f} tok/s, {waves} decode waves; TTFT"
          f" {', '.join(f'rid {k_} {v:.3f}s' for k_, v in ttft.items())}; search passes per"
          f" prefill {searches}; {card}")
    check(searches[MLA_RUN["short_len"]] == 0,
          f"the S {MLA_RUN['short_len']} prefill searched: {searches}")
    print(f"[mla-serve] the S {MLA_RUN['short_len']} prefill replayed [mla]'s plans: 0 search"
          " passes")

    # the block plans at each prompt length, on layer 0's (and the first MoE
    # layer's) own input; chunked_ffn on the longest prefill's layer-0 calls
    cfs = {key[2]: cf for key, cf in M._AC_CACHE.items()}
    check(set(cfs) == {dtag, mtag}, f"prefill plans {sorted(cfs)}")
    plans, errs = {}, {}
    p0 = M._index_tree(model.layer_params(0))
    for S in dict.fromkeys(run["prompts"]):
        prompt = next(r.prompt for r in reqs if len(r.prompt) == S)
        h0 = M.embed_inputs(cfg, model, {"tokens": torch.tensor([prompt], device="cuda")})[0]
        plans[S], hk = mla_block_plans(torch, M, cfg, model, cfs, h0, card,
                                       label=f"[mla-serve] block plan S={S}")
        if S == run["prompts"][0]:
            calls = capture_ffn_calls(torch, CF, lambda: cfs[dtag](p0, h0))
            check(len(calls) == plans[S][dtag]["swiglu_chunks"] > 0,
                  f"{len(calls)} chunked_ffn calls in layer 0, plan {plans[S][dtag]['loops']}")
            hold_calls_both_dtypes(torch, "chunked_ffn", f"mla-serve prefill S={S} layer 0",
                                   [(c, {}) for c in calls], CF.chunked_ffn,
                                   CF.chunked_ffn_plain, errs)
            del calls
        del h0, hk
        torch.cuda.empty_cache()
    want_ffn = sum(k * plans[len(r.prompt)][dtag]["swiglu_chunks"]
                   + (L - k) * plans[len(r.prompt)][mtag]["swiglu_chunks"] for r in reqs)
    print(f"[mla-serve] launches while serving: chunked_ffn {launches['chunked_ffn']} (= sum"
          f" over the 3 prefills of {k} dense x SwiGLU chunks + {L - k} MoE x SwiGLU chunks ="
          f" {want_ffn}; the plain wave dispatches nothing), computed_attention"
          f" {launches['computed_attention']}, masked_attention {launches['masked_attention']}"
          " (MLA's scores: generic loops)")
    check(launches["chunked_ffn"] == want_ffn > 0, f"mla-serve chunked_ffn launches"
          f" {launches['chunked_ffn']}, want {want_ffn}")
    check(launches["computed_attention"] == launches["masked_attention"] == 0,
          f"attention kernels launched on MLA: {launches}")

    # the same requests with the plain versions swapped in (information)
    plain_reqs = [Request(rid=100 + r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                  for r in reqs]
    restore = swap_plain(CA, CF)
    try:
        for r in plain_reqs:
            engine.submit(r)
        engine.run()
    finally:
        restore()
    same = sum(a == b for r, rp in zip(reqs, plain_reqs) for a, b in zip(r.generated, rp.generated))
    print(f"[mla-serve] the same requests with the plain versions swapped in: {same} of {toks}"
          f" tokens equal to the kernels'")

    # the compiled wave (budget 0.5) against the plain one on the same cache,
    # next tokens and positions: slot 0 ends holding rid 0, slot 1 rid 2
    before = stats.snapshot()
    t0 = time.perf_counter()
    e2 = ServeEngine(cfg_ac, model, max_batch=B, max_len=run["max_len"],
                     autochunk_budget=run["wave_budget"], device="cuda")
    wave_build = time.perf_counter() - t0
    dw = stats.delta(before)
    res = e2.autochunk_result
    wave_plan = dict(stages=len(res.plan), baseline_peak=res.baseline_peak,
                     final_peak=res.final_peak, budget_bytes=res.budget_bytes)
    del res
    for full, mine in zip(torch.utils._pytree.tree_leaves(e2.cache),
                          torch.utils._pytree.tree_leaves(engine.cache)):
        full.copy_(mine)
    last = (plain_reqs[0], plain_reqs[2])
    toks_w = torch.tensor([r.generated[-1] for r in last], device="cuda")
    pos_w = torch.tensor([len(r.prompt) + len(r.generated) - 1 for r in last], device="cuda")
    print(f"[mla-serve] compiled wave: built in {wave_build:.2f}s ({dw['trace_calls']} trace,"
          f" {dw['search_passes']} search passes), {wave_plan['stages']} stages, predicted peak"
          f" {wave_plan['baseline_peak']} -> {wave_plan['final_peak']} B (budget"
          f" {wave_plan['budget_bytes']} B); dispatch hits {dw['kernel_dispatch_hits']}"
          f" (computed mask {dw['kernel_dispatch_computed_mask']}), misses"
          f" {dw['kernel_dispatch_misses']}")
    check(dw["kernel_dispatch_computed_mask"] == 0, "an attention kernel matched MLA's wave")
    # both bf16 waves against the float32 wave from the same cache: the
    # compiled one no further from it than 1.5x the plain one
    with torch.no_grad():
        lg_ref = moe_wave_fp32(torch, M, cfg, model, e2.cache, toks_w, pos_w)[:, :cfg.vocab_size]
        lg_plain = engine._decode_wave(engine.cache, toks_w, pos_w)[:, :cfg.vocab_size]
        lg_comp = e2._decode_wave(e2.cache, toks_w, pos_w)[:, :cfg.vocab_size]
    atol, rtol = TOL["bfloat16"]
    diff = (lg_comp.float() - lg_plain.float()).abs()
    wave_err = float(diff.max())
    wave_share = float((diff / (atol + rtol * lg_plain.float().abs())).max())
    d_comp = float((lg_comp.float() - lg_ref).abs().max())
    d_plain = float((lg_plain.float() - lg_ref).abs().max())
    print(f"[mla-serve] compiled wave against the plain one, bf16 logits at positions"
          f" {pos_w.tolist()}: max_abs_err {wave_err:.3e} (max|plain|"
          f" {float(lg_plain.float().abs().max()):.3f}), {wave_share:.3f} of one kernel's bf16"
          f" limit {atol:g} + {rtol:g}|want|; from the float32 wave: compiled {d_comp:.3e},"
          f" plain {d_plain:.3e} (limit 1.5x the plain's); argmax equal to the float32 wave's"
          f" in {int((lg_comp.argmax(-1) == lg_ref.argmax(-1)).sum())} (compiled) and"
          f" {int((lg_plain.argmax(-1) == lg_ref.argmax(-1)).sum())} (plain) of {B} rows")
    check(bool(torch.isfinite(lg_comp).all()) and d_comp <= 1.5 * d_plain,
          f"compiled mla wave {d_comp} from float32, plain {d_plain}")
    del lg_ref, lg_plain, lg_comp, diff
    torch.cuda.empty_cache()
    wave_bytes = mla_wave_bytes(model, kv_bytes)
    with torch.no_grad():
        ms_plain = time_ms(torch, lambda: engine._decode_wave(engine.cache, toks_w, pos_w),
                           flush, reps=run["wave_reps"])
        ms_comp = time_ms(torch, lambda: e2._decode_wave(e2.cache, toks_w, pos_w), flush,
                          reps=run["wave_reps"])
    wave_bound = wave_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[mla-serve] decode wave {ms_comp:.3f} ms compiled, {ms_plain:.3f} ms plain"
          f" (CUDA-event medians of {run['wave_reps']}, {B} rows of {width} latent slots, {L}"
          f" layers); bound {wave_bound:.3f} ms (bytes: {wave_bytes} B of weights, every routed"
          f" expert included, and rings); {card}")
    del engine
    torch.cuda.empty_cache()
    before = stats.snapshot()
    compiles = e2.exec_stats["wave_compiles"]
    e2.reconfigure(max_len=run["second_max_len"])
    dr = stats.delta(before)
    print(f"[mla-serve] reconfigure(max_len={run['second_max_len']}): exec_len {e2.exec_len},"
          f" bucket_exec_hits {dr['bucket_exec_hits']}, trace_calls {dr['trace_calls']},"
          f" search_passes {dr['search_passes']}, wave_compiles"
          f" {e2.exec_stats['wave_compiles']} (was {compiles})")
    check(e2.exec_len == 16384 and dr["bucket_exec_hits"] == 1 and dr["trace_calls"] == 0
          and dr["search_passes"] == 0 and e2.exec_stats["wave_compiles"] == compiles,
          f"mla reconfigure inside the bucket: {dr}")
    del e2, model
    M._AC_CACHE.clear()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[mla-serve] bf16 part done in {seconds:.1f}s")
    return dict(build_s=build_s, exec_len=16384, ring_width=width, cache_bytes=kv_bytes,
                decompressed_kv_bytes=decompressed, wall_s=wall, tokens=toks,
                tok_s=toks / wall, decode_waves=waves, ttft_s=ttft, searches=searches,
                launches=launches, plans={str(s_): v for s_, v in plans.items()},
                plain_swapped_equal=same, wave_err=wave_err, wave_share_of_tol=wave_share,
                wave_err_from_fp32=d_comp, plain_wave_err_from_fp32=d_plain, wave_ms=ms_comp,
                plain_wave_ms=ms_plain, wave_bound_ms=wave_bound, wave_bytes=wave_bytes,
                wave_plan=wave_plan, wave_build_s=wave_build, errs=errs, seconds=seconds)


def mla_serve_fp32(torch, M, card, model32, cfg32):
    """``[mla]``'s 2-layer float32 model (one dense, one MoE layer, full
    width) served through ``ServeEngine``: one prompt of 256 tokens and 32
    new, at a capacity factor at which no expert can overflow in the
    forward; the served logits at the first and the last wave within 1e-3
    of ``forward(..., window=8192)`` over the sequence so far.  The wrap at
    float32 is held against the JAX package on the CPU
    (``tests/test_torch_mla_decode.py``): an unbudgeted float32 forward past
    8192 tokens does not fit the card."""
    from repro_torch.models import moe as MOE
    from repro_torch.serving import Request, ServeEngine

    run = MLA_SERVE
    t_phase = time.perf_counter()
    cfg = cfg32.with_(capacity_factor=run["fp32_capacity_factor"])
    n, m, W = run["fp32_prompt"], run["fp32_new"], cfg.sliding_window
    check(MOE.capacity(cfg, n + m) >= n + m, "fp32 mla: an expert's capacity below the length")
    engine = ServeEngine(cfg, model32, max_batch=1, max_len=run["max_len"], device="cuda")
    (req,) = make_requests(Request, cfg.vocab_size, run["fp32_seed"], (n,), (m,))
    kept, count, wave = {}, [0], engine._decode_wave
    at = {0: "first", m - 2: "last"}

    def spy(cache, toks, pos):
        logits = wave(cache, toks, pos)
        if count[0] in at:
            kept[at[count[0]]] = (int(pos[0]), logits[0].float().clone())
        count[0] += 1
        return logits

    engine._decode_wave = spy
    engine.submit(req)
    engine.run()
    engine._decode_wave = wave
    check(req.done and len(req.generated) == m, "fp32 mla serving: the request did not finish")
    seq = req.prompt + req.generated
    errs = {}
    with torch.no_grad():
        for name, (pos, got) in kept.items():
            toks = torch.tensor([seq[:pos + 1]], device="cuda")
            want = M.forward(cfg, model32, {"tokens": toks}, window=W)[0][0, -1]
            errs[name] = float((got[:cfg.vocab_size] - want[:cfg.vocab_size]).abs().max())
            del want
    print(f"[mla-serve] fp32 L={cfg.n_layers} ({cfg.first_k_dense} dense, 1 MoE) full width,"
          f" capacity factor {run['fp32_capacity_factor']:g} (each expert's capacity at least"
          f" the length: no expert overflows), prompt {n}, {m} new: decode logits against"
          f" forward(window={W}) over the sequence so far: "
          + ", ".join(f"{k_} wave (position {kept[k_][0]}) {v:.3e}" for k_, v in errs.items())
          + f" (limit 1e-3); {card}")
    check(max(errs.values()) <= 1e-3, f"fp32 mla served logits differ from the forward: {errs}")
    positions = {f"{k_}_position": p for k_, (p, _) in kept.items()}
    del engine, kept
    torch.cuda.empty_cache()
    return dict(positions, **{f"{k_}_err": v for k_, v in errs.items()},
                seconds=time.perf_counter() - t_phase)


def mla_serve_cli(torch):
    """``serve.main --arch deepseek-v3-671b --local`` on the card: the
    fixed-slot engine serves the reduced model; its ``[serve]`` lines."""
    import contextlib
    import io

    from repro_torch.launch import serve

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.main(MLA_SERVE["cli"])
    lines = [ln for ln in text.getvalue().splitlines() if ln.startswith("[serve]")]
    for ln in lines:
        print(f"[mla-serve] CLI deepseek-v3-671b --local: {ln}")
    check(any(re.match(r"\[serve\] 3 requests, 24 tokens ", ln) for ln in lines),
          "the serving CLI did not serve deepseek-v3-671b")
    torch.cuda.empty_cache()
    return lines


# ---------------------------------------------------------------------------
# [train]: gpt-paper trained at full width, gradients through the plan
# ---------------------------------------------------------------------------

TRAIN = dict(arch="gpt-paper", seed=21, batch=8, seq=1024, steps=30, lr=1e-3, warmup=2,
             min_drop=0.5,
             # float32 gradients through the plan: full width, 4 layers
             grad_layers=4, grad_seq=2048, grad_budget=0.2, grad_rtol=1e-4,
             # one long step, bf16 at full depth, unbudgeted and per block
             long_seq=8192, long_budget=0.2,
             cli=["--arch", "gpt-paper", "--steps", "3", "--batch", "4", "--seq", "1024"],
             cli_timeout=300)


def kernel_counters(CA, CF, PA, SS, RS):
    return {"computed_attention": CA.computed_attention, "masked_attention": CA.masked_attention,
            "chunked_ffn": CF.chunked_ffn, "paged_attention": PA.paged_attention_blocked,
            "ssd_scan": SS.ssd_scan, "rglru_scan": RS.rglru_scan}


def zero_launches(counters):
    for fn in counters.values():
        fn.launches = 0


def read_launches(counters):
    return {k: fn.launches for k, fn in counters.items()}


def timed_step(torch, step_fn, model, opt, batch):
    """One train step between CUDA events, the peak reset just before it:
    (model, opt, metrics, ms, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    model, opt, met = step_fn(model, opt, batch)
    e1.record()
    torch.cuda.synchronize()
    return model, opt, met, e0.elapsed_time(e1), torch.cuda.max_memory_allocated()


def block_cf(M, cfg):
    """The model's ``ChunkedFunction`` of its dense block under ``cfg``."""
    (cf,) = [v for k, v in M._AC_CACHE.items() if k[3] == cfg]
    return cf


def train_grads(torch, loss_fn, cfg, model, batch):
    for p in model.parameters():
        p.grad = None
    loss, _ = loss_fn(cfg, model, batch, remat=True)
    loss.backward()
    out = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), out


def run_train_phase(torch, CA, CF, PA, SS, RS, stats, M, card):
    """``[train]``: gpt-paper trained at full width and depth in bf16 (30
    steps of the synthetic stream, remat, float32 moments), its float32
    gradients at 4 layers through a budget-0.2 block plan against the
    unbudgeted ones, one S 8192 step unbudgeted and per block, the kernel
    wrappers' and the compiler's refusals, the checkpoint round trip and
    the train CLI.  No kernel is launched by a training step: a compile that
    needs gradients dispatches none."""
    from repro_torch.checkpointing import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import ChunkConfig, autochunk
    from repro_torch.data import make_batch, synthetic_stream
    from repro_torch.optim import adamw_init, linear_warmup_cosine
    from repro_torch.training import loss_fn, make_train_step

    t_phase = time.perf_counter()
    counters = kernel_counters(CA, CF, PA, SS, RS)
    out = {}
    T = TRAIN
    B, S = T["batch"], T["seq"]

    # ---- gpt-paper, full width and depth, bf16 --------------------------
    cfg = get_config(T["arch"])
    check(cfg.dtype == "bfloat16" and cfg.tie_embeddings, "gpt-paper is bf16 with tied embeddings")
    model = M.init_params(cfg, T["seed"], device="cuda").requires_grad_()
    n_params = sum(p.numel() for p in model.parameters())
    step_fn = make_train_step(cfg, linear_warmup_cosine(T["lr"], T["warmup"], T["steps"]))
    opt = adamw_init(dict(model.named_parameters()), moment_dtype="float32")
    data = synthetic_stream(cfg, B, S, seed=T["seed"], device="cuda")
    print(f"[train] {cfg.name} L={cfg.n_layers} d={cfg.d_model} V={cfg.vocab_size} bf16,"
          f" {n_params} params, f32 moments, batch {B} x {S}, remat, lr {T['lr']} warmup"
          f" {T['warmup']}, {T['steps']} steps; {card}")
    zero_launches(counters)
    steps = []
    for i in range(T["steps"]):
        batch = next(data)
        model, opt, met, ms, peak = timed_step(torch, step_fn, model, opt, batch)
        m = {k: float(v) for k, v in met.items()}
        check(math.isfinite(m["loss"]), f"[train] step {i}: loss {m['loss']}")
        steps.append(dict(step=i, loss=m["loss"], ce=m["ce"], lr=m["lr"], ms=ms,
                          tok_s=B * S / (ms / 1e3), peak=peak))
        print(f"[train] step {i:2d}: loss {m['loss']:.4f} ce {m['ce']:.4f} lr {m['lr']:.3e}"
              f" {ms:.2f} ms {B * S / (ms / 1e3):.0f} tok/s max_memory_allocated {peak} B")
    launches = read_launches(counters)
    drop = steps[0]["loss"] - steps[-1]["loss"]
    med = statistics.median(s["ms"] for s in steps[1:])
    print(f"[train] gpt-paper: loss {steps[0]['loss']:.4f} -> {steps[-1]['loss']:.4f} (drop"
          f" {drop:.4f}, limit {T['min_drop']}); median step {med:.2f} ms"
          f" ({B * S / (med / 1e3):.0f} tok/s); launches {launches}; {card}")
    check(drop >= T["min_drop"], f"[train] the loss fell {drop:.4f} < {T['min_drop']}")
    check(not any(launches.values()), f"[train] a training step launched a kernel: {launches}")
    out["gpt_paper"] = dict(params=n_params, steps=steps, drop=drop, median_ms=med,
                            launches=launches)
    lap("train: gpt-paper 30 steps")

    # ---- the checkpoint of the trained model ------------------------------
    tmp = tempfile.mkdtemp(prefix="train_ck_")
    try:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "gpt-paper.npz")
        save_checkpoint(path, model, step=T["steps"])
        back, step = load_checkpoint(path, model)
        seconds = time.perf_counter() - t0
        named = dict(model.named_parameters())
        equal = step == T["steps"] and all(
            torch.equal(p.view(torch.int16), named[k].view(torch.int16))
            for k, p in back.named_parameters())
        size = os.path.getsize(path)
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[train] checkpoint: {size} B .npz saved and loaded in {seconds:.2f}s,"
          f" bit-equal {equal}")
    check(equal, "[train] the reloaded bf16 checkpoint differs from the trained model")
    out["checkpoint"] = dict(bytes=size, seconds=seconds, bit_equal=equal)

    # ---- refusals ---------------------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(T["seed"])
    q, k, v = (torch.randn((12, 256, 64), generator=g, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    x = torch.randn((256, 768), generator=g, device="cuda", dtype=torch.bfloat16)
    wg, wu = (torch.randn((768, 2048), generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
              for _ in range(2))
    wd = torch.randn((2048, 768), generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
    refusals = {}
    zero_launches(counters)
    for name, call in (
            ("computed_attention", lambda: CA.computed_attention(
                q.requires_grad_(True), k, v, scale=0.125)),
            ("chunked_ffn", lambda: CF.chunked_ffn(x, wg.requires_grad_(True), wu, wd)),
            ("kernel_dispatch='on'", lambda: autochunk(
                lambda p, h: M.dense_block_full(cfg, p, h),
                ChunkConfig(budget_ratio=0.2, kernel_dispatch="on", weight_argnums=(0,)))
                .compile(M._index_tree(model["blocks"], 0),
                         torch.zeros((1, 512, 768), device="cuda", dtype=torch.bfloat16)))):
        try:
            call()
            refusals[name] = None
        except NotImplementedError as e:
            refusals[name] = str(e)
        print(f"[train] refusal {name} with an input that requires grad:"
              f" {'raised NotImplementedError: ' + refusals[name][:90] if refusals[name] else 'DID NOT RAISE'}")
    with torch.no_grad():      # the same calls without gradients launch
        ref_out = CA.computed_attention(q, k, v, scale=0.125)
        check(torch.isfinite(ref_out.float()).all(), "computed_attention under no_grad")
    check(all(refusals.values()), f"[train] a refusal did not raise: {refusals}")
    check(read_launches(counters)["computed_attention"] == 1
          and read_launches(counters)["chunked_ffn"] == 0,
          f"[train] launches around the refusals: {read_launches(counters)}")
    out["refusals"] = {k: bool(v) for k, v in refusals.items()}
    del q, k, v, x, wg, wu, wd, ref_out

    # ---- one long step, unbudgeted and per block --------------------------
    long = {}
    Sl = T["long_seq"]
    lbatch = make_batch(cfg, 1, Sl, seed=T["seed"] + 1, device="cuda")
    M._AC_CACHE.clear()
    for label, run_cfg in (("unbudgeted", cfg),
                           ("budget", cfg.with_(autochunk_budget=T["long_budget"]))):
        fn = make_train_step(run_cfg, linear_warmup_cosine(T["lr"], T["warmup"], T["steps"]))
        zero_launches(counters)
        t0 = time.perf_counter()
        model, opt, met, ms, peak = timed_step(torch, fn, model, opt, lbatch)
        wall = time.perf_counter() - t0
        check(math.isfinite(float(met["loss"])), f"[train] long step {label}: loss")
        rec = dict(ms=ms, wall_s=wall, peak=peak, loss=float(met["loss"]))
        if label == "budget":
            cf = block_cf(M, run_cfg)
            r = cf.autochunk_result
            check(len(r.plan) >= 1, "[train] the S 8192 block plan has no stage")
            # the first call compiled: time a second step on the warm plan
            model, opt, met, ms2, peak2 = timed_step(torch, fn, model, opt, lbatch)
            rec.update(stages=len(r.plan), warm_ms=ms2, warm_peak=peak2,
                       predicted_forward_peak=r.final_peak, baseline_forward_peak=r.baseline_peak,
                       loops=[(st.n_chunks, st.chunk_extent, st.n_loop_eqns) for st in r.plan],
                       compile_s=r.elapsed_s)
            print(f"[train] long S={Sl} block plan (grad compile, {r.elapsed_s:.2f} host s):"
                  f" {len(r.plan)} stage(s) " + ", ".join(
                      f"[n={st.n_chunks} extent {st.chunk_extent} loop nodes {st.n_loop_eqns}"
                      f" peak {st.peak_before} -> {st.peak_after} B]" for st in r.plan)
                  + f"; predicted forward block peak {r.baseline_peak} -> {r.final_peak} B")
        launches = read_launches(counters)     # every step of this label
        check(not any(launches.values()), f"[train] long step {label} launched {launches}")
        rec["launches"] = launches
        long[label] = rec
        print(f"[train] long S={Sl} bf16 remat step {label}: {ms:.2f} ms (wall {wall:.2f}s"
              + (f", warm {rec['warm_ms']:.2f} ms, peak {rec['warm_peak']} B" if label == "budget"
                 else "") + f") max_memory_allocated {peak} B, loss {rec['loss']:.4f};"
              f" launches {launches}; {card}")
    out["long"] = long
    del lbatch, opt, data, step_fn
    model.requires_grad_(False)
    del model
    M._AC_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    lap("train: checkpoint, refusals, long step")

    # ---- float32 gradients through the plan (4 layers, S 2048) -----------
    cfg32 = get_config(T["arch"]).with_(dtype="float32", n_layers=T["grad_layers"])
    model32 = M.init_params(cfg32, T["seed"] + 2, device="cuda").requires_grad_()
    gbatch = make_batch(cfg32, 1, T["grad_seq"], seed=T["seed"] + 3, device="cuda")
    bcfg = cfg32.with_(autochunk_budget=T["grad_budget"])
    zero_launches(counters)
    before = stats.snapshot()
    loss0, g0 = train_grads(torch, loss_fn, cfg32, model32, gbatch)
    loss1, g1 = train_grads(torch, loss_fn, bcfg, model32, gbatch)
    d = stats.delta(before)
    launches = read_launches(counters)
    cf = block_cf(M, bcfg)
    r = cf.autochunk_result
    worst = {}
    for name, want in g0.items():
        scale = float(want.abs().max())
        err = float((g1[name] - want).abs().max())
        worst[name] = err / scale if scale else err
        print(f"[train] grad f32 {name}: max|g| {scale:.4e} max|delta| {err:.4e} ratio"
              f" {worst[name]:.3e} (limit {T['grad_rtol']})")
    print(f"[train] grad f32 L={cfg32.n_layers} S={T['grad_seq']} budget {T['grad_budget']}:"
          f" loss {loss0:.6f} / {loss1:.6f}; plan {len(r.plan)} stage(s) "
          + ", ".join(f"[n={st.n_chunks} extent {st.chunk_extent}]" for st in r.plan)
          + f"; dispatch hits {d['kernel_dispatch_hits']}; launches {launches}; worst ratio"
          f" {max(worst.values()):.3e}")
    check(len(r.plan) >= 1, "[train] the float32 block plan has no stage")
    check(max(worst.values()) <= T["grad_rtol"],
          f"[train] float32 gradients through the plan: worst ratio {max(worst.values()):.3e}")
    check(not any(launches.values()) and d["kernel_dispatch_hits"] == 0,
          f"[train] a gradient step launched a kernel: {launches}")
    # the same block's inference plan compiled beside it: its own key, kernels
    with torch.no_grad():
        p0 = M._index_tree(model32["blocks"], 0)
        h0, _ = M.embed_inputs(cfg32, model32, gbatch)
        before = stats.snapshot()
        cf(p0, h0)
        d_inf = stats.delta(before)
    keys = [c.result.cache_key for c in cf._compiled.values()]
    print(f"[train] plan keys: training {keys[0][:16]}, inference {keys[-1][:16]}"
          f" ({len(set(keys))} distinct of {len(keys)}); the inference compile dispatched"
          f" {d_inf['kernel_dispatch_hits']} site(s)")
    check(len(keys) == 2 and len(set(keys)) == 2,
          f"[train] the training and inference plans share a key: {keys}")
    check(d_inf["kernel_dispatch_hits"] >= 1, "[train] the inference plan dispatched nothing")
    out["grad_fp32"] = dict(layers=cfg32.n_layers, seq=T["grad_seq"], budget=T["grad_budget"],
                            stages=len(r.plan), worst_ratio=max(worst.values()),
                            worst=worst, launches=launches, keys_distinct=len(set(keys)))
    del model32, g0, g1, gbatch, p0, h0
    M._AC_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the train CLI as a subprocess ------------------------------------
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"] + T["cli"],
                          env=env, capture_output=True, text=True, timeout=T["cli_timeout"])
    cli_s = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for ln in lines:
        print(f"[train] CLI {' '.join(T['cli'])}: {ln}")
    check(proc.returncode == 0, f"[train] the train CLI exited {proc.returncode}:"
          f" {proc.stderr[-2000:]}")
    check(any(ln.startswith("[train] done: loss ") for ln in lines),
          "[train] the train CLI printed no '[train] done' line")
    out["cli"] = dict(lines=lines, seconds=cli_s)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[train] phase done in {out['seconds']:.1f}s (CLI {cli_s:.1f}s)")
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
    global _T_START
    _T_START = time.perf_counter()
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
    lap("build")
    # host work that needs no card runs beside the phases before it: the
    # precompile CLI of the [cache] phase (a subprocess) and the searches
    # of the float32 compiled forwards (two child processes on meta, at low
    # priority); [compile] and [cache] wait for their results
    plans_dir = tempfile.TemporaryDirectory(prefix="plans-")
    fp32_dir = tempfile.TemporaryDirectory(prefix="plans-fp32-")
    background = concurrent.futures.ThreadPoolExecutor(1)
    precompiled = background.submit(precompile_plans, plans_dir.name)
    planners = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    cfg_fp32 = get_config("gpt-paper").with_(scan_layers=False, dtype="float32")
    fp32_planned = {mode: planners.submit(plan_forward_on_meta, cfg_fp32, mode,
                                          COMPILE["seq_len"], fp32_dir.name)
                    for mode in ("auto", "bool")}
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
    obs_reset()             # [obs]: the timed run's spans and histograms alone
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
    obs = obs_serving_window(engine, steps, len(reqs), card)
    obs["trace_export"] = obs_trace_export()

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
    obs_split_line(obs, busy if busy else None, wall, card)
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

    # ---- 4d. [obs]: the cost of recording a step, decode with obs on / off -
    obs["cost"] = obs_step_cost(engine, obs["median_step_s"], card)
    obs_reset()
    obs["on_off"] = obs_on_off(torch, engine, cfg, card)
    lap("obs")
    del engine, params

    # ---- 4e. phi3-mini-3.8b served at full width: its hd 96 on the kernel -
    # (counts zeroed just before, read just after); hd 48 still refused
    torch.cuda.empty_cache()
    phi3_serve = serve_phi3(torch, PA, stats, M, lens, card)

    # ---- 4f. phi3-mini-3.8b's prefix cache and host spill tier -----------
    # (counts zeroed just before the scenario, read just after); the cache
    # off beside it, fp32 on/off at 4 layers, then the serving CLI's
    # --shared-prefix scenario at gpt-paper's width
    torch.cuda.empty_cache()
    prefix_serve = serve_prefix(torch, PA, stats, M, card)
    prefix_serve["cli"] = serve_prefix_cli(torch, stats)
    lap("serve, prefix")
    for dt_name, err in prefix_serve["paged_errs"].items():
        max_err[dt_name] = max(max_err[dt_name], err)

    # ---- 5. served logits against the dense forward, fp32 ----------------
    # gpt-paper at full depth, phi3-mini at 4 layers
    prompt = rng.integers(0, cfg.vocab_size, 600).tolist()
    check_served_logits(torch, M, cfg.with_(dtype="float32"), 1, prompt)
    pcfg = get_config("phi3-mini-3.8b")
    phi3_serve["fp32_logits_err"] = check_served_logits(
        torch, M, pcfg.with_(dtype="float32", n_layers=4), 4,
        rng.integers(0, pcfg.vocab_size, 600).tolist(), label=f"phi3-mini-3.8b L=4 hd={pcfg.hd} ")
    lap("served float32 logits")

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
    lap("estimator")

    # ---- 7. times at the serving shapes ----------------------------------
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    timed = time_paged_kernel(torch, F, PA, {k: shapes[k] for k in
                                             ("gpt_decode", "gpt_serve_decode", "gpt_mixed",
                                              "phi3_serve_decode", "phi3_mixed")},
                              cases, flush, card)
    lap("paged times")

    # ---- 8. the compiler path: autochunk on gpt-paper at full width ------
    # compile + drive (counts zeroed just before, read just after), for the
    # computed-mask kernel and then, under mask_mode="bool", the masked one;
    # each followed by the float32 check of chunked against unchunked logits
    from repro_torch.kernels import chunked_attention as CA

    cfg_c = cfg.with_(scan_layers=False)                  # 12 layers, bf16
    fwd = {}
    cold = {}
    for mode in ("auto", "bool"):
        fwd[mode] = run_compiled_forward(torch, CA, stats, M, cfg_c, card, mask_mode=mode,
                                         keep=cold if mode == "auto" else None)
        torch.cuda.empty_cache()
        lap(f"compiled forward {mode}")
    fp32_err = check_forward_fp32(torch, M, cfg_c, cold, fp32_planned, fp32_dir.name)
    planners.shutdown()
    torch.cuda.empty_cache()
    lap("float32 compiled forwards")

    # ---- 8b. the plan cache: precompiled gpt-paper replayed from disk ----
    cache_run = run_cache_phase(torch, CA, stats, M, cfg_c, cold, card, precompiled,
                                plans_dir.name)
    background.shutdown()
    plans_dir.cleanup()
    del cold
    fp32_dir.cleanup()
    torch.cuda.empty_cache()
    lap("compile, cache")

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
    lap("attention kernels, minitron and phi3 per block")

    # ---- 13c. the fixed-slot engine: phi3-mini-3.8b past its window ------
    # (counts zeroed just before serving, read just after); the block plans
    # and layer-0 kernel checks, the plain versions swapped in, the compiled
    # wave and its warm reconfigure, fp32 at 4 layers, the CLI at gpt-paper's
    # width
    torch.cuda.empty_cache()
    slot = run_slot_phase(torch, CA, CF, stats, M, flush, card)
    for (kname, dt_name), err in slot.pop("errs").items():
        attn_err[(kname, dt_name)] = max(attn_err.get((kname, dt_name), 0.0), err)
    lap("slot")

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
    lap("scans, ssm and hybrid forwards")

    # ---- 16c. the fixed-slot engine on mamba2-1.3b and recurrentgemma-9b --
    # (counts zeroed just before serving, read just after); the prefill
    # block plans, the kernels on the layers' own inputs, the plain versions
    # swapped in, mamba2's compiled wave, fp32 at reduced depth, the CLI
    slot_ssm = run_slot_ssm_phase(torch, CA, SS, RS, stats, M, flush, card)
    for arch in SLOT_SSM["models"]:
        for (kname, dt_name), err in slot_ssm[arch].pop("errs").items():
            table = {"ssd_scan": ssd_err, "rglru_scan": rglru_err}.get(kname, None)
            if table is None:
                attn_err[(kname, dt_name)] = max(attn_err.get((kname, dt_name), 0.0), err)
            else:
                table[dt_name] = max(table.get(dt_name, 0.0), err)
    torch.cuda.empty_cache()

    lap("slot-ssm")

    # ---- 17. the scans' times at their models' shapes ---------------------
    scan_timed = time_scans(torch, SS, RS, flush, card)

    # ---- 17b. the attention kernels at the new head dims' model shapes ---
    # phi3-mini's per-block chunk (hd 96), recurrentgemma's (hd 256, MQA in
    # its window), hubert-xlarge's encoder attention (hd 80, not causal)
    # (phi3's kernel call: a chunk of rows of 32 heads, or every row of a
    # chunk of heads)
    p3 = phi3["bfloat16"]
    sq3, n3 = ((p3["attention_chunk"], 32) if p3["attention_by"] == "rows"
               else (PHI3["seq_len"], p3["attention_chunk"]))
    hd_timed = {
        "phi3_hd96": time_attention_kernels(torch, F, CA, sq3, PHI3["seq_len"], flush, card,
                                            attn_err, N=n3, hd=96),
        "recurrentgemma_hd256": time_attention_kernels(
            torch, F, CA, hyb_budget["attention_chunk"], HYBRID_RUN["seq_len"], flush, card,
            attn_err, N=hcfg.n_kv_heads, group=hcfg.n_heads // hcfg.n_kv_heads, hd=hcfg.hd,
            window=hcfg.local_window),
        "hubert_hd80": time_attention_kernels(torch, F, CA, 1024, 8192, flush, card, attn_err,
                                              N=16, hd=80, causal=False),
    }

    # ---- 17c. qwen2-moe-a2.7b per block at full width and depth ----------
    # (counts zeroed just before the per-block forward, read just after);
    # both kernels on layer 0's own calls; fp32 at 2 layers, bf16 at 4
    moe = run_moe_forward(torch, CA, CF, stats, M, card, attn_err, ffn_err)
    torch.cuda.empty_cache()
    lap("scan and head-dim times, moe")

    # ---- 17d. qwen2-moe-a2.7b served through the fixed-slot engine ------
    # (the [moe] weights freed first; counts zeroed just before serving,
    # read just after); the block plans and both kernels on layer 0's own
    # calls, the plain versions swapped in, the compiled wave and its warm
    # reconfigure, fp32 at 2 layers against the forward, the CLI
    moe_serve = run_moe_serve(torch, CA, CF, stats, M, flush, card)
    for (kname, dt_name), err in moe_serve.pop("errs").items():
        if kname == "chunked_ffn":
            ffn_err[dt_name] = max(ffn_err.get(dt_name, 0.0), err)
        else:
            attn_err[(kname, dt_name)] = max(attn_err.get((kname, dt_name), 0.0), err)
    torch.cuda.empty_cache()
    # its engines and model are deleted: what stays allocated before any
    # garbage collection (no engine holds a reference cycle)
    moe_serve["allocated_after"] = torch.cuda.memory_allocated()
    print(f"[moe-serve] on the card after its engines and model are deleted, before any"
          f" garbage collection: {moe_serve['allocated_after']} B allocated")
    lap("moe-serve")

    # ---- 17e. deepseek-v3-671b's MLA forward per block (5 layers) --------
    # (the [moe-serve] weights freed first; counts zeroed just before the
    # per-block forward, read just after); the plans, chunked_ffn on layer
    # 0's and the shared expert's calls, the S 2048 forwards and the MTP
    # head; the model stays for [mla-serve]
    mla, mla_state = run_mla_forward(torch, F, CA, CF, stats, M, flush, card)
    for (kname, dt_name), err in mla.pop("errs").items():
        ffn_err[dt_name] = max(ffn_err.get(dt_name, 0.0), err)
    lap("mla, bf16")

    # ---- 17f. deepseek-v3-671b served through the fixed-slot engine ------
    # on [mla]'s model (counts zeroed just before serving, read just after):
    # the latent cache's bytes, the block plans and chunked_ffn on the
    # longest prefill's layer-0 calls, the plain versions swapped in, the
    # compiled wave against the plain one and float32, its warm reconfigure
    t_mla_serve = time.perf_counter()
    mla_serve = run_mla_serve(torch, CA, CF, stats, M, flush, card, mla_state)
    for (kname, dt_name), err in mla_serve.pop("errs").items():
        ffn_err[dt_name] = max(ffn_err.get(dt_name, 0.0), err)
    lap("mla-serve, bf16")
    t_mla_serve = time.perf_counter() - t_mla_serve

    # ---- 17g. [mla]'s float32 checks (they consume the bf16 model), then --
    # the 2-layer float32 model served and the serving CLI
    model32, cfg32 = finish_mla_forward(torch, M, card, mla, mla_state)
    lap("mla, float32")
    t0 = time.perf_counter()
    mla_serve["fp32"] = mla_serve_fp32(torch, M, card, model32, cfg32)
    del model32
    mla_serve["cli"] = mla_serve_cli(torch)
    set_allocator(torch, "expandable_segments:False")
    mla_serve["seconds"] = t_mla_serve + time.perf_counter() - t0
    print(f"[mla-serve] phase done in {mla_serve['seconds']:.1f}s (its bf16 part, float32"
          " serving and the CLI)")
    lap("mla-serve, float32 and CLI")

    # ---- 17h. training: gpt-paper at full width, gradients through the plan
    # (counts zeroed just before each training run, read just after: a
    # compile that needs gradients dispatches no kernel, so every count is 0)
    train = run_train_phase(torch, CA, CF, PA, SS, RS, stats, M, card)
    lap("train")

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
    # launches while serving the recurrent families through the slot engine
    slot_ssm_launches = {
        "ssd_scan": slot_ssm["mamba2-1.3b"]["launches"]["ssd_scan"],
        "rglru_scan": slot_ssm["recurrentgemma-9b"]["launches"]["rglru_scan"],
        "computed_attention": slot_ssm["recurrentgemma-9b"]["launches"]["computed_attention"]}
    moe_launches = {"computed_attention": moe["attention_launches"],
                    "chunked_ffn": moe["chunked_ffn_launches"]}
    moe_serve_launches = moe_serve["launches"]
    mla_launches = {"computed_attention": mla["attention_launches"],
                    "masked_attention": mla["masked_launches"],
                    "chunked_ffn": mla["chunked_ffn_launches"]}
    mla_serve_launches = mla_serve["launches"]
    print("kernels: " + json.dumps([{"name": k, "launches": n,
                                     "slot_ssm_launches": slot_ssm_launches.get(k, 0),
                                     "moe_launches": moe_launches.get(k, 0),
                                     "moe_serve_launches": moe_serve_launches.get(k, 0),
                                     "mla_launches": mla_launches.get(k, 0),
                                     "mla_serve_launches": mla_serve_launches.get(k, 0),
                                     "train_launches": train["gpt_paper"]["launches"][k],
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
    entries[0]["obs"] = obs
    entries[0]["train"] = train
    entries[0]["phi3_serve"] = phi3_serve
    entries[0]["prefix_serve"] = prefix_serve
    entries[1]["cache"] = cache_run
    entries[1]["block_shape"] = block_attn_timed
    entries[1]["hybrid_budget_forward"] = hyb_budget
    entries[1]["phi3_forward"] = phi3
    entries[1]["slot_serve"] = slot
    entries[1]["slot_ssm_serve"] = {
        "launches": slot_ssm_launches["computed_attention"],
        "plans": slot_ssm["recurrentgemma-9b"]["plans"]}
    for i, kname in ((1, "computed_attention"), (2, "masked_attention")):
        entries[i]["head_dim_shapes"] = {k: t[kname] for k, t in hd_timed.items()}
    entries[1]["moe_forward"] = moe
    entries[1]["moe_launches"] = moe_launches["computed_attention"]
    entries[1]["moe_serve_launches"] = moe_serve_launches["computed_attention"]
    entries[1]["moe_serve"] = moe_serve
    entries[2]["moe_serve_launches"] = moe_serve_launches["masked_attention"]
    for i, kname in ((1, "computed_attention"), (2, "masked_attention")):
        entries[i]["mla_launches"] = mla_launches[kname]
        entries[i]["mla_serve_launches"] = mla_serve_launches[kname]
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
        "slot_serve": {k: slot[k] for k in ("chunked_ffn_launches", "plans")},
        "moe_launches": moe_launches["chunked_ffn"],
        "moe_forward": {k: moe[k] for k in ("chunked_ffn_launches", "loops", "stages")},
        "moe_serve_launches": moe_serve_launches["chunked_ffn"],
        "moe_serve": {k: moe_serve[k] for k in ("launches", "plans")},
        "mla_launches": mla_launches["chunked_ffn"],
        "mla_forward": mla,
        "mla_serve_launches": mla_serve_launches["chunked_ffn"],
        "mla_serve": mla_serve,
        "tensor_core_instructions": routes["chunked_ffn"],
    })
    for kname, line, run, arch in (("ssd_scan", 78, ssm, "mamba2-1.3b"),
                                   ("rglru_scan", 49, hyb, "recurrentgemma-9b")):
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
            "slot_ssm_serve": slot_ssm[arch],
            "tensor_core_instructions": routes[kname],
        })
    entries[-2]["max_err_state_fp32"] = ssd_err["state"]
    entries[-2]["slot_ssm_cli"] = slot_ssm["cli"]
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
