"""Training substrate: loss, train_step factory, and the host loop.

The loss path reuses the exact inference ``forward`` (plus the MTP head for
DeepSeek-V3), with remat over layer blocks.  AutoChunk composes with the
backward: with ``cfg.autochunk_budget`` each block runs its chunked plan,
and autograd differentiates the emitted chunk loops.  A compile that needs
gradients dispatches no kernel (no kernel has a backward), so training runs
the generic chunk loops, as the JAX package's training does wherever its
tests run.  A port of ``repro/training/loop.py``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from ..checkpointing import save_checkpoint
from ..configs.base import ModelConfig
from ..models import model as M
from ..optim import adamw_init, adamw_update, linear_warmup_cosine

SCAN_FAMILIES = ("ssm", "hybrid")


def cross_entropy(logits, labels):
    """Mean token CE in f32.  logits (B,S,V), labels (B,S) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    return (logz - gold).mean()


def loss_fn(cfg: ModelConfig, params, batch, *, window=None, remat: bool = True):
    """Returns ``(loss, metrics)``: ``ce``, ``aux``, ``loss`` and, with
    ``cfg.mtp``, ``mtp_ce`` (0-d f32 tensors)."""
    logits, aux = M.forward(cfg, params, batch, window=window, remat=remat)
    labels = batch["labels"]
    if cfg.family == "vlm":  # text logits follow the patch tokens
        ce = cross_entropy(logits[:, cfg.n_frontend_tokens:, :], labels)
    else:
        ce = cross_entropy(logits, labels)
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp:
        # the MTP head on the re-embedded inputs, as the JAX package
        # computes it (the forward does not hand back its hidden states)
        h, _ = M.embed_inputs(cfg, params, batch)
        mtp_lg = M.mtp_logits(cfg, params, batch, h)
        mtp_ce = cross_entropy(mtp_lg[:, :-1], labels[:, 1:-1])
        loss = loss + 0.3 * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def refuse_scan_families(cfg: ModelConfig) -> None:
    """The ssm and hybrid families cannot train yet: raise naming A12(b)."""
    if cfg.family in SCAN_FAMILIES:
        raise NotImplementedError(
            f"training the {cfg.family} family: its scan ops (ssd_scan, rglru_scan) have"
            " no autograd; ROADMAP A12(b): gradients of the scan ops")


def make_train_step(cfg: ModelConfig, lr_fn: Callable, *, window=None, remat: bool = True,
                    weight_decay: float = 0.1):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt, metrics)``.

    ``model`` is a trainable :class:`~repro_torch.models.model.Model`
    (``model.requires_grad_()``); ``opt_state`` an :class:`AdamWState` over
    ``dict(model.named_parameters())``.  The step writes the new
    parameters into the model in place and leaves no ``.grad`` behind."""
    refuse_scan_families(cfg)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, metrics = loss_fn(cfg, model, batch, window=window, remat=remat)
        loss.backward()
        lr = lr_fn(opt_state.step + 1)  # step counts completed updates
        grads = {k: p.grad for k, p in params.items()}
        new, opt_state = adamw_update(params, grads, opt_state, lr,
                                      weight_decay=weight_decay)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
                p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["lr"] = lr
        return model, opt_state, metrics

    return train_step


def run_train(cfg: ModelConfig, params, data: Iterator[Dict[str, Any]], *, steps: int,
              base_lr: float = 3e-4, warmup: int = 20, log_every: int = 10,
              checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
              window=None, log_fn: Callable[[str], None] = print):
    """Single-device training loop; ``params`` is a ``Model``, made
    trainable here.  Returns ``(model, opt_state, history)``."""
    lr_fn = linear_warmup_cosine(base_lr, warmup, steps)
    step_fn = make_train_step(cfg, lr_fn, window=window)   # refuses ssm / hybrid
    params.requires_grad_()
    opt_state = adamw_init(dict(params.named_parameters()), moment_dtype="float32")
    history = []
    t0 = time.perf_counter()  # monotonic: durations survive clock steps
    for step in range(steps):
        batch = next(data)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            log_fn(f"step {step:5d} loss={m['loss']:.4f} ce={m['ce']:.4f}"
                   f" lr={m['lr']:.2e} ({time.perf_counter()-t0:.1f}s)")
        if checkpoint_path and checkpoint_every and step and step % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, params, step=step)
    if checkpoint_path:
        save_checkpoint(checkpoint_path, params, step=steps)
    return params, opt_state, history
