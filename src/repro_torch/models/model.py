"""Model assembly: init and full-sequence forward of the dense, MoE (MLA
included), SSM and hybrid families, and the MTP head; the serving caches,
decode step and prefill of the dense, vlm, MoE (MLA's latent cache
included), SSM and hybrid families.

Parameters live in a :class:`Model` (an ``nn.Module``) whose ``state_dict``
keys follow the JAX package's pytree paths: ``blocks.0.attn.wq`` for the
list form, ``blocks.attn.wq`` with a leading layer axis for the stacked
(``scan_layers``) form.  The functions below read it like the JAX dicts
(``params["blocks"][0]["attn"]["wq"]``), so each one maps line for line
onto its counterpart in the JAX package's ``models/model.py``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import _pytree as pytree

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import rglru as RG
from . import ssm as SSM

DENSE_FAMILIES = ("dense", "vlm", "encoder", "audio")
FAMILIES = DENSE_FAMILIES + ("moe", "ssm", "hybrid")


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
        """Block ``i``'s params: a slice of the stacked form, or list entry.
        A MoE model's layers are its ``dense_blocks`` (a list), then its
        ``blocks``."""
        if "dense_blocks" in self._modules:
            dense = self["dense_blocks"]
            if i < len(dense):
                return dense[i]
            i -= len(dense)
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

def _attn_block_params(cfg, gen, *, device):
    return {
        "ln1": L.norm_params(cfg, cfg.d_model, device=device),
        "ln2": L.norm_params(cfg, cfg.d_model, device=device),
        "attn": (MLA.mla_params(cfg, gen, device=device) if cfg.mla
                 else L.attn_params(cfg, gen, device=device)),
    }


def dense_block_params(cfg, gen, *, device, d_ff=None):
    p = _attn_block_params(cfg, gen, device=device)
    p["mlp"] = L.mlp_params(cfg, gen, device=device, f=d_ff or cfg.d_ff)
    return p


def moe_block_params(cfg, gen, *, device):
    p = _attn_block_params(cfg, gen, device=device)
    p["moe"] = MOE.moe_params(cfg, gen, device=device)
    return p


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
        raise ValueError(cfg.family)
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
    elif cfg.family == "moe":
        # a list of dense prefix blocks, then the MoE blocks (stacked or not)
        k = cfg.first_k_dense
        p["dense_blocks"] = [dense_block_params(cfg, generator, device=dev)
                             for _ in range(k)]
        blocks = [moe_block_params(cfg, generator, device=dev)
                  for _ in range(cfg.n_layers - k)]
        p["blocks"] = _stack(blocks) if cfg.scan_layers else blocks
    else:
        block_params = ssm_block_params if cfg.family == "ssm" else dense_block_params
        blocks = [block_params(cfg, generator, device=dev) for _ in range(cfg.n_layers)]
        p["blocks"] = _stack(blocks) if cfg.scan_layers else blocks
    if cfg.mtp:
        d = cfg.d_model
        p["mtp_proj"] = L._normal(generator, (2 * d, d), 1.0 / math.sqrt(2 * d),
                                  cfg.torch_dtype, dev)
        p["mtp_block"] = dense_block_params(cfg, generator, device=dev)
        p["mtp_norm"] = L.norm_params(cfg, d, device=dev)
    return Model(cfg, p)


# ===========================================================================
# Block applications (full-sequence)
# ===========================================================================

def attn_apply_full(cfg, p, x, positions=None, *, window, causal):
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    h = L.apply_norm(cfg, x, p["ln1"])
    if cfg.mla:
        o, _ = MLA.mla_attention_prefill(cfg, p["attn"], h, positions, window=window)
        return x + o
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


def moe_block_full(cfg, p, x, positions=None, *, window=None):
    """Returns (x, the router's aux loss)."""
    x = attn_apply_full(cfg, p, x, positions, window=window, causal=True)
    h = L.apply_norm(cfg, x, p["ln2"])
    ff, aux = MOE.moe_ffn(cfg, p["moe"], h)
    return x + ff, aux


def ssm_block_full(cfg, p, x):
    return ssm_block_state(cfg, p, x)[0]


def ssm_block_state(cfg, p, x):
    """The SSM block that also hands back its scan's final f32 state (the
    prefill's); the same operations as :func:`ssm_block_full`."""
    h = L.apply_norm(cfg, x, p["ln1"])
    y, (state, _) = SSM.ssm_block(cfg, p["ssm"], h)
    return x + y, state


def rg_block_full(cfg, p, x):
    return rg_block_state(cfg, p, x)[0]


def rg_block_state(cfg, p, x):
    """The RG-LRU block that also hands back its recurrence's final f32
    state (the prefill's); the same operations as :func:`rg_block_full`."""
    h = L.apply_norm(cfg, x, p["ln1"])
    y, (state, _) = RG.recurrent_block(cfg, p["rec"], h)
    x = x + y
    h = L.apply_norm(cfg, x, p["ln2"])
    return x + L.mlp(cfg, p["mlp"], h), state


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
    """Full-sequence forward of the dense, MoE, SSM and hybrid families
    (MoE with MLA attention too, as deepseek-v3 has it).  Returns (logits,
    aux_loss): the MoE routers' load-balance loss summed over the MoE
    layers, 0 for the other families.

    With ``cfg.autochunk_budget`` each block runs the AutoChunk plan of one
    block, compiled at the first layer of its kind and replayed for the
    rest: one plan for a dense or SSM model, two for the hybrid (its local
    attention block, tag ``hyb_attn``, and its RG-LRU block, ``hyb_rg``),
    and for MoE one for its dense prefix (``densepre{window}``) and one for
    its MoE blocks (``moe{window}``, returning the block's aux loss too).
    The SSM and RG-LRU scans stay one kernel op inside the compiled block;
    MLA's summed scores stay a generic chunk loop (no attention kernel
    computes them).  The MTP head is :func:`mtp_logits`, which the forward
    does not call.
    """
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(fam)
    h, _ = embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if fam in DENSE_FAMILIES:
        h = _run_blocks(cfg, params, h, f"dense{window}",
                        lambda p, x: dense_block_full(cfg, p, x, window=window,
                                                      causal=cfg.causal))
    elif fam == "ssm":
        h = _run_blocks(cfg, params, h, "ssm", lambda p, x: ssm_block_full(cfg, p, x))
    elif fam == "moe":
        dense = lambda p, x: dense_block_full(cfg, p, x, window=window)
        moe = lambda p, x: moe_block_full(cfg, p, x, window=window)
        if cfg.autochunk_budget:
            if cfg.first_k_dense:
                dense = _maybe_autochunk(cfg, f"densepre{window}", dense)
            moe = _maybe_autochunk(cfg, f"moe{window}", moe)
        for i in range(cfg.n_layers):
            p = params.layer_params(i)
            if cfg.autochunk_budget and isinstance(p, nn.Module):
                p = _index_tree(p)   # the compiler takes a dict of tensors
            if i < cfg.first_k_dense:
                h = dense(p, h)
            else:
                h, aux_i = moe(p, h)
                aux = aux + aux_i
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


@torch.no_grad()
def mtp_logits(cfg: ModelConfig, params, batch, h_final):
    """DeepSeek-V3 MTP head: predict token t+2 from (h_t, emb_{t+1}).
    ``h_final`` (B,S,d); returns (B,S-1,V)."""
    tokens = batch["tokens"]
    emb_next = L.embed(cfg, params["embed"], tokens[:, 1:])
    h_in = torch.cat([L.apply_norm(cfg, h_final[:, :-1], params["mtp_norm"]), emb_next],
                     dim=-1) @ params["mtp_proj"]
    positions = torch.arange(h_in.shape[1], dtype=torch.int32, device=h_in.device)
    h = dense_block_full(cfg, params["mtp_block"], h_in, positions)
    return L.unembed(cfg, params["embed"], h)


# ===========================================================================
# KV / state caches (serving)
# ===========================================================================
# A cache spec is a ``meta`` tensor (the port's ShapeDtypeStruct); a cache
# is the same tree of zero tensors on a device.  K/V, MLA's latents and conv
# windows are in the model's dtype, the SSM and RG-LRU states in f32.

def cache_width(cfg: ModelConfig, max_len: int) -> int:
    """Ring width of an attention cache: the sliding window when it is
    shorter than ``max_len``, else ``max_len``."""
    if cfg.sliding_window is not None and max_len > cfg.sliding_window:
        return cfg.sliding_window
    return max_len


def _spec(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def layer_cache_spec(cfg: ModelConfig, kind: str, batch: int, width: int):
    """One layer's cache spec: ``{"k", "v"}`` of (batch, width, Kv, hd) for
    ``attn``, or with MLA the latent ring ``{"ckv": (batch, width,
    kv_lora_rank), "kr": (batch, width, qk_rope_dim)}``; ``local_attn``
    caps the width at ``cfg.local_window``; ``{"state", "conv"}`` for
    ``ssm`` and ``rglru``."""
    if kind in ("ssm", "rglru"):
        specs = SSM.ssm_state_specs if kind == "ssm" else RG.rglru_state_specs
        state, conv = specs(cfg, batch)
        return {"state": state, "conv": conv}
    if kind not in ("attn", "local_attn"):
        raise ValueError(kind)
    if cfg.mla and kind == "attn":
        return {"ckv": _spec((batch, width, cfg.kv_lora_rank), cfg.torch_dtype),
                "kr": _spec((batch, width, cfg.qk_rope_dim), cfg.torch_dtype)}
    w = min(width, cfg.local_window) if kind == "local_attn" else width
    shape = (batch, w, cfg.n_kv_heads, cfg.hd)
    return {"k": _spec(shape, cfg.torch_dtype), "v": _spec(shape, cfg.torch_dtype)}


def layer_kinds(cfg: ModelConfig):
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return ["attn"] * cfg.n_layers
    if fam == "ssm":
        return ["ssm"] * cfg.n_layers
    if fam == "hybrid":
        return ["local_attn" if cfg.is_attention_layer(i) else "rglru"
                for i in range(cfg.n_layers)]
    raise ValueError(f"{fam} has no decode cache")


def _stack_specs(per_layer):
    return {k: _spec((len(per_layer),) + tuple(per_layer[0][k].shape), per_layer[0][k].dtype)
            for k in per_layer[0]}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """Specs of the whole cache: ``{"layers": {leaf: (L, batch, ...)}}`` for
    ``scan_layers`` (the stacked form), ``{"layers": [per layer]}`` otherwise,
    as the JAX package lays them out.  A stacked MoE model's cache is
    ``{"moe_layers": {leaf: (L - k, batch, ...)}}`` plus ``"dense_layers"``,
    a list of its ``k = cfg.first_k_dense`` dense prefix layers, when k > 0."""
    width = cache_width(cfg, max_len)
    per_layer = [layer_cache_spec(cfg, k, batch, width) for k in layer_kinds(cfg)]
    if cfg.scan_layers and cfg.family in ("dense", "vlm", "ssm"):
        return {"layers": _stack_specs(per_layer)}
    if cfg.scan_layers and cfg.family == "moe":
        dense, moe_layers = per_layer[: cfg.first_k_dense], per_layer[cfg.first_k_dense:]
        out = {"moe_layers": _stack_specs(moe_layers)}
        if dense:
            out["dense_layers"] = dense
        return out
    return {"layers": per_layer}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """A zero cache for ``batch`` rows of up to ``max_len`` positions."""
    dev = resolve_device(device)
    return pytree.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                           cache_specs(cfg, batch, max_len))


def _layer_cache(cache, i: int):
    """Layer ``i``'s cache dict: entries of the list form, views into the
    stacked form (writes into them reach the cache).  In the stacked MoE
    layout layer ``i < first_k_dense`` is entry ``i`` of ``dense_layers``
    and every later layer is a view into ``moe_layers`` at ``i - k``."""
    if "moe_layers" in cache:
        dense = cache.get("dense_layers", [])
        if i < len(dense):
            return dense[i]
        i, layers = i - len(dense), cache["moe_layers"]
    else:
        layers = cache["layers"]
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return {k: v[i] for k, v in layers.items()}


def _cache_leaves(cache):
    """[(leaf, its batch dim)] of every leaf of ``cache``, in key order:
    dim 1 of a stacked leaf (``layers`` or ``moe_layers`` as a dict; dim 0
    is the layer), dim 0 of a list entry's (``layers`` or ``dense_layers``
    as a list)."""
    out = []
    for key in sorted(cache):
        part = cache[key]
        if isinstance(part, (list, tuple)):
            out += [(layer[k], 0) for layer in part for k in sorted(layer)]
        else:
            out += [(part[k], 1) for k in sorted(part)]
    return out


def write_cache_row(cache, row: int, one) -> None:
    """Copy ``one``, a one-row cache of the same layout (a request's
    prefill), into row ``row`` of every leaf of the batched ``cache``."""
    dst, src = _cache_leaves(cache), _cache_leaves(one)
    if len(dst) != len(src):
        raise ValueError(f"cache layouts differ: {len(dst)} leaves against {len(src)}")
    for (full, bdim), (part, _) in zip(dst, src):
        full.select(bdim, row).copy_(part.select(bdim, 0))


# ===========================================================================
# Decode step (serving): one token per row against the ring cache
# ===========================================================================

def _ring_kv_positions(pos, width: int):
    """Position held by each ring slot after position ``pos`` was written:
    ``pos - (pos - i) % width`` (negative: never written).  ``pos`` (B,)
    gives (B, width)."""
    i = torch.arange(width, dtype=torch.int64, device=pos.device)
    pos = pos.to(torch.int64)[..., None]
    return pos - torch.remainder(pos - i, width)


def attn_block_decode(cfg, p, x, cache, pos, *, window=None, local=False):
    """x: (B,1,d), ``pos`` (B,): row ``b``'s token sits at ``pos[b]``.

    Writes each row's K/V (with MLA its latent ``ckv`` and RoPE key ``kr``)
    into its cache row at slot ``pos[b] % width`` in place, then attends
    over that row's ring positions.  Returns ``x`` plus the attention
    output.  MLA attends to the whole ring, as the JAX package's decode
    does: a ring as wide as the window holds exactly the window."""
    B = x.shape[0]
    h = L.apply_norm(cfg, x, p["ln1"])
    width = cache["ckv" if cfg.mla else "k"].shape[1]
    slot = torch.remainder(pos, width).to(torch.int64)
    kv_pos = _ring_kv_positions(pos, width)
    rows = torch.arange(B, device=x.device)
    if cfg.mla:
        ckv, k_rope = MLA.mla_latent(cfg, p["attn"], h, pos[:, None])
        cache["ckv"][rows, slot] = ckv[:, 0]
        cache["kr"][rows, slot] = k_rope[:, 0]
        return x + MLA.mla_attention_decode(cfg, p["attn"], h, cache["ckv"], cache["kr"],
                                            pos, kv_pos >= 0)
    q, k, v = L.attn_project_qkv(cfg, p["attn"], h, pos[:, None])
    cache["k"][rows, slot] = k[:, 0]
    cache["v"][rows, slot] = v[:, 0]
    win = cfg.local_window if local else window
    o = L.gqa_attention(q, cache["k"], cache["v"], q_pos=pos[:, None].to(torch.int64),
                        kv_pos=kv_pos, causal=True, window=win, kv_valid=kv_pos >= 0)
    return x + o.reshape(B, 1, -1) @ p["attn"]["wo"]


def dense_block_decode(cfg, p, x, cache, pos, *, window=None, local=False):
    x = attn_block_decode(cfg, p, x, cache, pos, window=window, local=local)
    h = L.apply_norm(cfg, x, p["ln2"])
    return x + L.mlp(cfg, p["mlp"], h)


def moe_block_decode(cfg, p, x, cache, pos, *, window=None):
    """The MoE block at one token a row: attention on the ring (written in
    place), then the experts.  Each row is a routing group of one token, so
    its capacity is 8 and nothing drops; the router's aux loss is not
    served."""
    x = attn_block_decode(cfg, p, x, cache, pos, window=window)
    h = L.apply_norm(cfg, x, p["ln2"])
    ff, _ = MOE.moe_ffn(cfg, p["moe"], h)
    return x + ff


def ssm_block_decode(cfg, p, x, cache):
    """x: (B,1,d).  Advances the layer's SSD state and conv window, written
    into ``cache`` in place; returns ``x`` plus the block's output."""
    h = L.apply_norm(cfg, x, p["ln1"])
    y, (state, conv) = SSM.ssm_block(cfg, p["ssm"], h, state=cache["state"],
                                     conv_state=cache["conv"], decode=True)
    # both are new tensors (the window a slice of a fresh concatenation), so
    # the copies do not read what they overwrite
    cache["state"].copy_(state)
    cache["conv"].copy_(conv)
    return x + y


def rg_block_decode(cfg, p, x, cache):
    """x: (B,1,d).  Advances the layer's RG-LRU state and conv window in
    ``cache`` in place; returns the block's output."""
    h = L.apply_norm(cfg, x, p["ln1"])
    y, (state, conv) = RG.recurrent_block(cfg, p["rec"], h, state=cache["state"],
                                          conv_state=cache["conv"], decode=True)
    cache["state"].copy_(state)
    cache["conv"].copy_(conv)
    x = x + y
    h = L.apply_norm(cfg, x, p["ln2"])
    return x + L.mlp(cfg, p["mlp"], h)


def _check_decode_family(cfg: ModelConfig):
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid"):
        raise ValueError(f"{cfg.family} has no decode cache")


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *, window=None):
    """One serving step: ``tokens`` (B,1) int, ``pos`` (B,) int (or one int
    for every row).  Returns ``(logits (B,1,V), cache)``: the cache is the
    same object, its rows written in place (the JAX package returns a new
    one).  ``params`` is a :class:`Model`.  The SSM and RG-LRU layers carry
    no position; the hybrid's attention layers attend within
    ``cfg.local_window`` on their rings.  A MoE model's dense prefix layers
    run the dense block, its later layers the MoE block; with MLA each
    attends in the absorbed form against its latent ring.  The loop indexes
    by layer, so the stacked and the list form both serve."""
    _check_decode_family(cfg)
    if window is None:
        window = cfg.sliding_window
    h = L.embed(cfg, params["embed"], tokens)
    pos = torch.as_tensor(pos, device=h.device)
    if pos.dim() == 0:
        pos = pos.expand(h.shape[0])
    for i in range(cfg.n_layers):
        p, c = params.layer_params(i), _layer_cache(cache, i)
        if cfg.family == "ssm":
            h = ssm_block_decode(cfg, p, h, c)
        elif cfg.family == "moe" and i >= cfg.first_k_dense:
            h = moe_block_decode(cfg, p, h, c, pos, window=window)
        elif cfg.family != "hybrid":
            h = dense_block_decode(cfg, p, h, c, pos, window=window)
        elif cfg.is_attention_layer(i):
            h = dense_block_decode(cfg, p, h, c, pos, local=True)
        else:
            h = rg_block_decode(cfg, p, h, c)
    h = L.apply_norm(cfg, h, params["final_norm"])
    return L.unembed(cfg, params["embed"], h), cache


class _DecodeWave(nn.Module):
    """``decode_step`` of a model as a module, for ``functional_call``."""

    def __init__(self, model: Model):
        super().__init__()
        self.model = model

    def forward(self, cache, tokens, pos):
        return decode_step(self.model.cfg, self.model, cache, tokens[:, None], pos)[0][:, 0]


def decode_fn(model: Model):
    """``fn(params, cache, tokens, pos) -> logits (B, V)``: one decode wave
    (``tokens`` and ``pos`` both (B,)) over a dict of parameter tensors
    (``dict(model.named_parameters())``), writing the cache in place.  The
    form the AutoChunk compiler traces, as :func:`logits_fn` is for the
    forward: the weights are inputs of the graph."""
    wave = _DecodeWave(model)

    def fn(params, cache, tokens, pos):
        named = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(wave, named, (cache, tokens, pos))

    return fn


# ===========================================================================
# Prefill: the prompt's forward that also fills the decode cache
# ===========================================================================

@torch.no_grad()
def prefill(cfg: ModelConfig, params: Model, batch, max_len: int, *, window=None):
    """Run the full prompt; returns ``(logits (B,S,V), cache)`` with each
    attention layer's K/V of the prompt (with MLA its latents ``ckv`` and
    ``kr``) in the ring layout of width ``cache_width(cfg, max_len)``
    (``cfg.local_window`` at most for the hybrid's), and each SSM or RG-LRU
    layer's final state and conv window.

    One pass: each attention layer's K/V (or latents) are projected from
    its normed input, then the block runs; with ``cfg.autochunk_budget``
    the block is the per-block compiled function the forward uses (its
    attention and SwiGLU MLP on their kernels).  An SSM or RG-LRU block hands back its scan's final
    state too, so it is compiled under its own tag (``ssm_prefill``,
    ``hyb_rg_prefill``); its conv window, the last W-1 rows of the conv
    input, is projected from the last rows of the normed input outside the
    block.  A MoE model's blocks are the forward's per-block functions
    under its tags (``densepre{window}`` for the dense prefix,
    ``moe{window}`` for the MoE blocks, whose aux loss is dropped), so a
    prefill at a length the forward has planned replays the forward's plan;
    its cache comes back in :func:`cache_specs`'s layout for the config's
    form.  The JAX package runs the forward, then the stack again to
    capture the caches; the logits and caches are the same."""
    _check_decode_family(cfg)
    if window is None:
        window = cfg.sliding_window
    h, positions = embed_inputs(cfg, params, batch)
    S = h.shape[1]
    width = cache_width(cfg, max_len)
    fam = cfg.family

    if fam == "ssm":
        blocks = {"ssm_prefill": lambda p, x: ssm_block_state(cfg, p, x)}
    elif fam == "hybrid":
        blocks = {"hyb_attn": lambda p, x: dense_block_full(cfg, p, x, window=cfg.local_window),
                  "hyb_rg_prefill": lambda p, x: rg_block_state(cfg, p, x)}
    elif fam == "moe":
        # the forward's blocks and tags, the dense prefix's only if it has one
        blocks = {f"moe{window}": lambda p, x: moe_block_full(cfg, p, x, window=window)}
        if cfg.first_k_dense:
            blocks[f"densepre{window}"] = lambda p, x: dense_block_full(cfg, p, x, window=window)
    else:
        blocks = {f"dense{window}": lambda p, x: dense_block_full(cfg, p, x, window=window,
                                                                   causal=cfg.causal)}
    if cfg.autochunk_budget:
        blocks = {tag: _maybe_autochunk(cfg, tag, fn) for tag, fn in blocks.items()}
    caches = []
    for i in range(cfg.n_layers):
        p = params.layer_params(i)
        if isinstance(p, nn.Module):
            p = _index_tree(p)   # the compiler takes a nested dict of tensors
        if fam == "ssm" or (fam == "hybrid" and not cfg.is_attention_layer(i)):
            conv = _conv_window(cfg, p, h)
            h, state = blocks["ssm_prefill" if fam == "ssm" else "hyb_rg_prefill"](p, h)
            caches.append({"state": state, "conv": conv})
            continue
        hn = L.apply_norm(cfg, h, p["ln1"])
        if cfg.mla:
            ckv, k_rope = MLA.mla_latent(cfg, p["attn"], hn, positions)
            kv = {"ckv": ckv, "kr": k_rope}
        else:
            _, k, v = L.attn_project_qkv(cfg, p["attn"], hn, positions)
            kv = {"k": k, "v": v}
        w = min(width, cfg.local_window) if fam == "hybrid" else width
        caches.append(_pad_kv(kv, w, S))
        if fam == "hybrid":
            h = blocks["hyb_attn"](p, h)
        elif fam != "moe":
            h = blocks[f"dense{window}"](p, h)
        elif i < cfg.first_k_dense:
            h = blocks[f"densepre{window}"](p, h)
        else:
            h = blocks[f"moe{window}"](p, h)[0]
    h = L.apply_norm(cfg, h, params["final_norm"])
    logits = L.unembed(cfg, params["embed"], h)
    if cfg.scan_layers and fam in ("dense", "vlm", "ssm"):
        return logits, {"layers": _stack(caches)}
    if cfg.scan_layers and fam == "moe":
        k = cfg.first_k_dense
        out = {"moe_layers": _stack(caches[k:])}
        if k:
            out["dense_layers"] = caches[:k]
        return logits, out
    return logits, {"layers": caches}


def _conv_window(cfg, p, x):
    """A recurrent block's conv window, the last W-1 rows of its conv input:
    those rows of ``x`` normed (a row-wise norm, so the rows of the normed
    whole) times the conv input's weight columns (the SSM block's input
    projection's x, B and C columns, the RG-LRU block's ``w_x``); zeros
    before the prompt's first token, as the causal conv pads."""
    if cfg.family == "ssm":
        di, N, W = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv_width
        w_cols = p["ssm"]["w_in"][:, di:2 * di + 2 * N]   # ssm_block splits z, x, B, C, dt
    else:
        w_cols, W = p["rec"]["w_x"], cfg.rglru_conv_width
    tail = L.apply_norm(cfg, x[:, -(W - 1):], p["ln1"]) @ w_cols
    return F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))


def _pad_kv(c, width: int, S: int):
    """Place the last min(S, width) positions into the ring layout."""
    def fix(x):
        if x.dim() < 2 or x.shape[1] == width:
            return x
        if x.shape[1] > width:  # keep the window tail, ring-aligned
            # position of tail[j] is S - width + j; its slot is pos % width
            return torch.roll(x[:, -width:], (S - width) % width, dims=1)
        pad = x.new_zeros((x.shape[0], width - x.shape[1]) + tuple(x.shape[2:]))
        return torch.cat([x, pad], dim=1)

    return {k: fix(v) for k, v in c.items()}
