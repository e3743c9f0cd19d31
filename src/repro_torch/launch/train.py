"""Training CLI: the synthetic stream through ``run_train`` on one device.

  python -m repro_torch.launch.train --arch gpt-paper --steps 30 --batch 8 --seq 1024

trains ``--arch`` at its full width from random weights (``--seed``) on the
CUDA device by default; ``--device cpu`` runs on the CPU.  ``--local``
trains ``reduced()`` of the config in float32 (CPU-runnable).
``--autochunk B`` runs each block through its AutoChunk plan under the
activation budget B (the backward differentiates the chunk loops; no kernel
is dispatched in a compile that needs gradients).  ``--checkpoint PATH``
writes the trained parameters to ``PATH`` (.npz, the JAX package's key
paths).  Prints the JAX package's ``[train]`` lines and a ``step`` line
every 10 steps and at the last.  The ssm and hybrid families are refused
(ROADMAP A12(b): their scan ops have no autograd).
"""
from __future__ import annotations

import argparse

from ..configs import get_config
from ..data import synthetic_stream
from ..device import resolve_device
from ..models import model as M
from ..training import run_train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--local", action="store_true",
                    help="reduced config in float32 (CPU-runnable)")
    ap.add_argument("--autochunk", type=float, default=None)
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.local:
        cfg = cfg.reduced().with_(dtype="float32")
    if args.autochunk:
        cfg = cfg.with_(autochunk_budget=args.autochunk)

    params = M.init_params(cfg, args.seed, device=dev)
    n = sum(p.numel() for p in params.parameters())
    print(f"[train] {cfg.name} ({cfg.family}); {n/1e6:.1f}M params;"
          f" batch={args.batch} seq={args.seq}")
    data = synthetic_stream(cfg, args.batch, args.seq, seed=args.seed, device=dev)
    params, _, history = run_train(
        cfg, params, data,
        steps=args.steps, base_lr=args.lr,
        checkpoint_path=args.checkpoint, checkpoint_every=0,
    )
    print(f"[train] done: loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
