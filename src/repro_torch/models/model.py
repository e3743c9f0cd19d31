"""Model assembly: init and full-sequence forward of the dense, SSM and
hybrid families.

Parameters live in a :class:`Model` (an ``nn.Module``) whose ``state_dict``
keys follow the JAX package's pytree paths: ``blocks.0.attn.wq`` for the
list form, ``blocks.attn.wq`` with a leading layer axis for the stacked
(``scan_layers``) form.  The functions below read it like the JAX dicts
(``params["blocks"][0]["attn"]["wq"]``), so each one maps line for line
onto its counterpart in the JAX package's ``models/model.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from . import rglru as RG
from . import ssm as SSM

DENSE_FAMILIES = ("dense", "vlm", "encoder", "audio")
FAMILIES = DENSE_FAMILIES + ("ssm", "hybrid")


class ParamTree(nn.Module):
    """Nested dict/list of tensors as a module tree.

    Dicts become submodules, lists ``nn.ModuleList``s, tensors frozen
    parameters (the port serves; it does not train).  Indexing with
    ``tree["key"]`` reads like the JAX pytree.
    """

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)


class Model(ParamTree):
    """A model's parameters; ``model(tokens)`` runs :func:`forward`."""

    def __init__(self, cfg: ModelConfig, tree: Mapping[str, Any]):
        super().__init__(tree)
        self.cfg = cfg

    def layer_params(self, i: int):
        """Block ``i``'s params: a slice of the stacked form, or list entry."""
        blocks = self["blocks"]
        if isinstance(blocks, nn.ModuleList):
            return blocks[i]
        return _index_tree(blocks, i)

    def forward(self, tokens=None, *, window=None, **inputs):
        """``inputs`` are the batch's other entries (``frames``, ``patches``)."""
        batch = {"tokens": tokens, **inputs} if tokens is not None else inputs
        return forward(self.cfg, self, batch, window=window)


def logits_fn(model: Model):
    """``fn(params, batch) -> logits``: the forward over a dict of parameter
    tensors (``dict(model.named_parameters())``) and a batch dict
    (``tokens``, or ``frames`` / ``patches`` as the family takes).  The form
    the AutoChunk compiler traces: the weights are inputs of the graph, not
    constants baked into it."""

    def fn(params, batch):
        rest = {k: v for k, v in batch.items() if k != "tokens"}
        return torch.func.functional_call(model, params, (batch.get("tokens"),), rest)[0]

    return fn


def _index_tree(tree: ParamTree, i: Optional[int] = None) -> Dict[str, Any]:
    """A module tree as a nested dict of its tensors (entry ``i`` of each,
    for the stacked form)."""
    out: Dict[str, Any] = {}
    for name, p in tree.named_parameters(recurse=False):
        out[name] = p if i is None else p[i]
    for name, sub in tree.named_children():
        out[name] = _index_tree(sub, i)
    return out


# ===========================================================================
# Parameter construction
# ===========================================================================

def dense_block_params(cfg, gen, *, device, d_ff=None):
    return {
        "ln1": L.norm_params(cfg, cfg.d_model, device=device),
        "ln2": L.norm_params(cfg, cfg.d_model, device=device),
        "attn": L.attn_params(cfg, gen, device=device),
        "mlp": L.mlp_params(cfg, gen, device=device, f=d_ff or cfg.d_ff),
    }


def ssm_block_params(cfg, gen, *, device):
    return {"ln1": L.norm_params(cfg, cfg.d_model, device=device),
            "ssm": SSM.ssm_params(cfg, gen, device=device)}


def rg_block_params(cfg, gen, *, device):
    return {
        "ln1": L.norm_params(cfg, cfg.d_model, device=device),
        "ln2": L.norm_params(cfg, cfg.d_model, device=device),
        "rec": RG.rglru_params(cfg, gen, device=device),
        "mlp": L.mlp_params(cfg, gen, device=device),
    }


def _stack(trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, generator: Union[torch.Generator, int] = 0,
                *, device="cuda") -> Model:
    """Random parameters with the JAX package's distribution (not its numbers).

    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed.  On
    ``meta`` only shapes and dtypes are made and ``generator`` is unused.
    """
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port has the dense, ssm and hybrid families"
            " (ROADMAP queue A item 10 ports the others)"
        )
    if cfg.mla:
        raise NotImplementedError("MLA attention (ROADMAP queue A item 10)")
    dev = resolve_device(device)
    if dev.type == "meta":
        generator = None
    elif isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    p: Dict[str, Any] = {"embed": L.embed_params(cfg, generator, device=dev)}
    p["final_norm"] = L.norm_params(cfg, cfg.d_model, device=dev)
    if cfg.family == "hybrid":
        # heterogeneous layers: always the list form, as in the JAX package
        p["blocks"] = [dense_block_params(cfg, generator, device=dev)
                       if cfg.is_attention_layer(i)
                       else rg_block_params(cfg, generator, device=dev)
                       for i in range(cfg.n_layers)]
    else:
        block_params = ssm_block_params if cfg.family == "ssm" else dense_block_params
        blocks = [block_params(cfg, generator, device=dev) for _ in range(cfg.n_layers)]
        p["blocks"] = _stack(blocks) if cfg.scan_layers else blocks
    return Model(cfg, p)


# ===========================================================================
# Block applications (full-sequence)
# ===========================================================================

def attn_apply_full(cfg, p, x, positions=None, *, window, causal):
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    h = L.apply_norm(cfg, x, p["ln1"])
    q, k, v = L.attn_project_qkv(cfg, p["attn"], h, positions)
    o = L.gqa_attention(q, k, v, q_pos=positions, kv_pos=positions,
                        causal=causal, window=window)
    o = o.reshape(x.shape[0], x.shape[1], -1) @ p["attn"]["wo"]
    return x + o


def dense_block_full(cfg, p, x, positions=None, *, window=None, causal=None):
    causal = cfg.causal if causal is None else causal
    x = attn_apply_full(cfg, p, x, positions, window=window, causal=causal)
    h = L.apply_norm(cfg, x, p["ln2"])
    return x + L.mlp(cfg, p["mlp"], h)


def ssm_block_full(cfg, p, x):
    h = L.apply_norm(cfg, x, p["ln1"])
    y, _ = SSM.ssm_block(cfg, p["ssm"], h)
    return x + y


def rg_block_full(cfg, p, x):
    h = L.apply_norm(cfg, x, p["ln1"])
    y, _ = RG.recurrent_block(cfg, p["rec"], h)
    x = x + y
    h = L.apply_norm(cfg, x, p["ln2"])
    return x + L.mlp(cfg, p["mlp"], h)


# ===========================================================================
# Embedding of model inputs (tokens / audio frames / vision patches)
# ===========================================================================

def embed_inputs(cfg, params, batch: Dict[str, Any]):
    """Returns (h (B,S,d), positions (S,))."""
    if cfg.family == "audio":
        h = batch["frames"].to(cfg.torch_dtype)  # stub frontend embeddings
    elif cfg.family == "vlm":
        text = L.embed(cfg, params["embed"], batch["tokens"])
        patches = batch["patches"].to(cfg.torch_dtype)  # stub ViT embeddings
        h = torch.cat([patches, text], dim=1)
    else:
        h = L.embed(cfg, params["embed"], batch["tokens"])
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    return h, positions


# ===========================================================================
# Full-sequence forward
# ===========================================================================

# AutoChunk is a first-class config feature: when cfg.autochunk_budget is
# set, the block function is compiled through the AutoChunk pipeline (keyed
# by arch and budget, so the search runs once per input shape, not per layer).
_AC_CACHE: Dict[Any, Any] = {}


def _maybe_autochunk(cfg: ModelConfig, tag: str, fn):
    """The cached ``ChunkedFunction`` of block ``fn`` under ``cfg``'s budget."""
    from ..core import ChunkConfig, ChunkedFunction

    # one ChunkedFunction per (config, budget, block): it compiles lazily per
    # input shape and every layer of that shape replays the compiled plan.
    # The full (frozen, hashable) cfg is part of the key because ``fn``
    # closes over it: two reduced variants sharing a name must not share it.
    key = (cfg.name, cfg.autochunk_budget, tag, cfg)
    if key not in _AC_CACHE:
        chunk_cfg = ChunkConfig.from_scalar(
            cfg.autochunk_budget,
            weight_argnums=(0,),
            # dim 0 of every activation is the batch axis, as in the JAX package
            dim_blocklist=(0,),
        )
        _AC_CACHE[key] = ChunkedFunction(fn, chunk_cfg)
    return _AC_CACHE[key]


def _run_blocks(cfg: ModelConfig, params: Model, h, tag: str, block):
    """``h`` through ``block(p, x)`` at every layer; with
    ``cfg.autochunk_budget``, through the AutoChunk plan of one block,
    compiled at the first layer and replayed for the rest."""
    if not cfg.autochunk_budget:
        for i in range(cfg.n_layers):
            h = block(params.layer_params(i), h)
        return h
    fn = _maybe_autochunk(cfg, tag, block)
    blocks = params["blocks"]
    stacked = not isinstance(blocks, nn.ModuleList)
    for i in range(cfg.n_layers):
        # the compiler takes a nested dict of tensors, not a module
        h = fn(_index_tree(blocks, i) if stacked else _index_tree(blocks[i]), h)
    return h


@torch.no_grad()
def forward(cfg: ModelConfig, params: Model, batch, *, window: Optional[int] = None):
    """Full-sequence forward of the dense, SSM and hybrid families.
    Returns (logits, aux_loss).

    With ``cfg.autochunk_budget`` each block runs the AutoChunk plan of one
    block, compiled at the first layer of its kind and replayed for the
    rest: one plan for a dense or SSM model, two for the hybrid (its local
    attention block, tag ``hyb_attn``, and its RG-LRU block, ``hyb_rg``).
    The SSM and RG-LRU scans stay one kernel op inside the compiled block.
    """
    fam = cfg.family
    if fam not in FAMILIES:
        raise NotImplementedError(
            f"family {fam!r} (ROADMAP queue A item 10)")
    h, _ = embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if fam in DENSE_FAMILIES:
        h = _run_blocks(cfg, params, h, f"dense{window}",
                        lambda p, x: dense_block_full(cfg, p, x, window=window,
                                                      causal=cfg.causal))
    elif fam == "ssm":
        h = _run_blocks(cfg, params, h, "ssm", lambda p, x: ssm_block_full(cfg, p, x))
    else:
        blocks = {"hyb_attn": lambda p, x: dense_block_full(cfg, p, x, window=cfg.local_window),
                  "hyb_rg": lambda p, x: rg_block_full(cfg, p, x)}
        for i in range(cfg.n_layers):
            tag = "hyb_attn" if cfg.is_attention_layer(i) else "hyb_rg"
            p = params.layer_params(i)
            if cfg.autochunk_budget:
                # each kind compiled at its first layer, as in the JAX package;
                # the compiler takes a nested dict of tensors, not a module
                h = _maybe_autochunk(cfg, tag, blocks[tag])(_index_tree(p), h)
            else:
                h = blocks[tag](p, h)
    h = L.apply_norm(cfg, h, params["final_norm"])
    logits = L.unembed(cfg, params["embed"], h)
    return logits, aux
