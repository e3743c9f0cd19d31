"""Quickstart: the AutoChunk transform on a model's forward.

  python -m repro_torch.launch.quickstart --arch gpt-paper --seq-len 8192 --budget 0.2

compiles the forward of ``--arch`` (list-form layers, random weights and
tokens from seed 0) through ``autochunk(fn, ChunkConfig(budget_ratio=...))`` at one
sequence of ``--seq-len`` tokens, prints the compilation report, runs the
chunked and the unchunked forward, and prints the largest difference of
their logits.  It runs on the CUDA device by default, where the attention
sites run the fused CUDA kernels; ``--device cpu`` runs the plain PyTorch
versions.  ``--arch mamba2-1.3b`` compiles the SSM forward: each block's
scan stays one ``ssd_scan`` kernel op in the compiled graph.  ``--local``
compiles ``reduced()`` of the config with 2 layers in float32 (default
1024 tokens).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs import get_config
from ..core import ChunkConfig, autochunk, stats
from ..device import resolve_device
from ..models import model as M


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gpt-paper")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="tokens in the sequence (default 8192, 1024 with --local)")
    ap.add_argument("--budget", type=float, default=0.2,
                    help="<= 1: ratio of the baseline activation peak; > 1: bytes")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--local", action="store_true",
                    help="reduced() config, 2 layers, float32")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).with_(scan_layers=False)
    if args.local:
        cfg = cfg.reduced().with_(dtype="float32", n_layers=2, scan_layers=False)
    seq_len = args.seq_len or (1024 if args.local else 8192)
    model = M.init_params(cfg, 0, device=dev)
    params = dict(model.named_parameters())
    fn = M.logits_fn(model)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (1, seq_len)), device=dev)}

    before = stats.snapshot()
    t0 = time.perf_counter()
    chunked = autochunk(fn, ChunkConfig.from_scalar(args.budget))
    compiled = chunked.compile(params, batch)
    compile_s = time.perf_counter() - t0
    d = stats.delta(before)
    print(compiled.report())
    print(f"[quickstart] {cfg.name} L={cfg.n_layers} S={seq_len} {cfg.dtype} on {dev}:"
          f" compiled in {compile_s:.2f}s; kernel dispatch hits {d['kernel_dispatch_hits']}"
          f" (computed mask {d['kernel_dispatch_computed_mask']}),"
          f" misses {d['kernel_dispatch_misses']}")

    y1 = compiled(params, batch)
    y0 = fn(params, batch)
    err = float((y1.float() - y0.float()).abs().max())
    finite = bool(torch.isfinite(y1[..., :cfg.vocab_size]).all())
    print(f"[quickstart] output max |delta| vs the unchunked forward: {err:.3e};"
          f" finite: {finite}; activation peak"
          f" {compiled.result.baseline_peak / 2**20:.1f} ->"
          f" {compiled.result.final_peak / 2**20:.1f} MiB (predicted)")
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
