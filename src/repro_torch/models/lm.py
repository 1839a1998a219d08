"""DecoderLM for every decoder family and EncDecLM for whisper: training
loss, prefill, decode step and cache.

The counterpart of ``repro/models/lm.py`` (``cross_entropy``,
``DecoderLM``, ``EncDecLM``, ``build_model``) for dense configs
(qwen2-0.5b, qwen3-1.7b, yi-34b, mistral-large-123b), the MoE family
(granite-moe-3b-a800m, mixtral-8x22b, whose windowed layers decode over a
ring cache), the SSM
family (mamba2-780m), the hybrid family (hymba-1.5b: attention and SSD
heads in every layer, meta tokens, windowed and global layers) and the
vlm family (phi-3-vision-4.2b, whose CLIP frontend is a stub: a batch
carries precomputed ``patch_embeds``), in training and in serving (a K/V
cache for the families with attention, the conv tail and SSD state for
those with an SSM), and the encdec family (whisper-large-v3, whose audio
frontend is a stub: a batch carries frame embeddings ``frames`` (B,
max_source_positions, d_model)).  The model is an ``nn.Module`` holding
its parameters: a ``ModuleList`` of per-layer parameter dicts where JAX
scans over stacked leaves (two of them for encdec: ``encoder`` and the
decoder's ``layers``).

The prefix: the model runs ``[meta tokens | patch embeddings | text]``
(``_compose_input``), cuts the prefix before the unembedding in the loss,
makes the cache longer by ``prefix_len`` and offsets decode positions by
it, as ``repro`` does.  ``prefix_len`` counts the patches whether or not
a batch carries them, so a vlm served text-only decodes ``num_patches``
positions past its prompt (the reference's behaviour, kept).

Two ways to hold the parameters:
* serving (``trainable=False``): cast once at load to the compute dtype,
  except the leaves JAX uses in fp32, with no gradients;
* training (``trainable=True``): fp32 masters with ``requires_grad``, cast
  at each use as JAX casts them, so the gradients land on the masters.

Either may be held whole or as this rank's shards of a storage plan
(``plan``, ``dp_shard.ShardPlan.for_storage``: the dims the rules map to
the batch axes and to ``"model"``); ``init_sharded_params`` draws the
shards leaf by leaf from the generator sequence of the whole init, so a
rank never holds the whole tree.  A model on a plan is used inside the
manual region of its mesh: the data-parallel step, or ``_serve_wrap``,
under which prefill and decode gather each layer's batch-sharded leaves
(``_serve_params``) and the layers take their part of the model-sharded
ones (``layers.work``).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import dp_shard, model_axis
from repro_torch.distributed.sharding_rules import current_ctx
from repro_torch.models import layers as ll
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import stack as stk
from repro_torch.models.module import ParamSpec, init_params, map_specs, spec

# leaves JAX uses uncast (fp32) at every use: the norm scales, the
# layernorm's bias and the SSM's dt_bias, A_log and gate_norm
_FP32_LEAVES = frozenset({"scale", "bias", "q_norm", "k_norm"}) \
    | ssm_mod.FP32_LEAVES


def cross_entropy(logits, targets, mask):
    """fp32 cross-entropy (logsumexp, no z-loss) averaged over the tokens
    where mask (B,S) is 1."""
    ce_sum, denom = ll.xent_sum(logits, targets, mask)
    return ce_sum / denom


def _param(name: str, s: ParamSpec, t, device, index=None,
           trainable: bool = False, shape=None) -> nn.Parameter:
    """One leaf, checked against its spec (or ``shape``, a shard's) and
    moved to ``device``: an fp32 master that takes gradients if
    ``trainable``, else cast once to the compute dtype, unless JAX keeps
    the leaf in fp32."""
    if index is not None:
        t = t[index]
    if shape is None:
        shape = s.shape[1:] if index is not None else s.shape
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"parameter {name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    dtype = torch.float32 if trainable or name in _FP32_LEAVES \
        else ll.COMPUTE_DTYPE
    return nn.Parameter(t.to(device=device, dtype=dtype).contiguous(),
                        requires_grad=trainable)


def _check_tree(specs, values) -> None:
    if set(values) != set(specs):
        raise ValueError(f"parameter tree mismatch: expected "
                         f"{sorted(specs)}, got {sorted(values)}")


def _shape(plan, name: str, s: ParamSpec, stacked: bool):
    """The shape a leaf named ``name`` (a port name) is held at: its
    shard's under ``plan``, else its spec's (a layer's, if ``stacked``)."""
    shape = s.shape[1:] if stacked else s.shape
    return plan.local_shape(name, shape) if plan is not None else shape


def _param_dict(specs: Dict[str, ParamSpec], values, device, index=None,
                trainable: bool = False, *, prefix: str, plan=None):
    """A ParameterDict of one layer's (or one top-level group's) leaves
    (``_param`` each), named ``prefix.<leaf>`` in ``plan``."""
    _check_tree(specs, values)
    return nn.ParameterDict({
        name: _param(name, s, values[name], device, index, trainable,
                     _shape(plan, f"{prefix}.{name}", s, index is not None))
        for name, s in specs.items()})


def _layer_list(specs, values, num_layers: int, device,
                trainable: bool, *, prefix: str = "layers",
                plan=None) -> nn.ModuleList:
    """One ``ModuleDict`` of parameter groups per layer, each cut from the
    stacked (L, ...) leaves of ``values``."""
    return nn.ModuleList(
        nn.ModuleDict({group: _param_dict(s, values[group], device, index=i,
                                          trainable=trainable,
                                          prefix=f"{prefix}.{i}.{group}",
                                          plan=plan)
                       for group, s in specs.items()})
        for i in range(num_layers))


def _shard_leaf(plan, path, full):
    """A copy of this rank's shard under ``plan`` of the leaf at ``path``
    of a spec-layout tree (a stacked leaf cut layer by layer alike)."""
    if path[0] in ("layers", "encoder"):
        return plan.local(".".join((path[0], "0") + path[1:]), full,
                          lead=1).clone()
    return plan.local(".".join(path), full).clone()


def init_sharded_params(cfg: ModelConfig, generator: torch.Generator, plan):
    """This rank's shards of ``cfg``'s parameters under ``plan``, in the
    spec tree's layout (a stacked leaf as the stack of its layers' shards):
    each leaf drawn whole from ``generator`` in ``init_params``' order,
    cut and copied, and freed before the next, so the values are those of
    the whole init and a rank never holds more than one whole leaf."""
    return init_params(param_specs(cfg), generator,
                       shard=lambda path, full: _shard_leaf(plan, path, full))


def shard_params(tree, plan):
    """This rank's fp32 shards under ``plan`` of a whole spec-layout tree
    of tensors or arrays, converted and cut leaf by leaf."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return _shard_leaf(plan, path, torch.as_tensor(node,
                                                       dtype=torch.float32))
    return walk(tree, ())


def top_axes(specs):
    """The logical axes of the groups outside the layer stacks."""
    return {k: v for k, v in map_specs(lambda s: s.axes, specs).items()
            if k not in ("layers", "encoder")}


def _store_leaves(cache, i: int, leaves, S: int, ring: bool,
                  kv=None, cross=None) -> None:
    """Write layer i's cache leaves from a prefill of S positions into
    ``cache`` in place: K/V up to the cache's length (a ring of T slots
    keeps the last T positions, rolled so position p sits in slot p % T),
    every other leaf whole, each cast to its cache dtype.  With ``kv`` (a
    split of the model ranks, ``stack.kv_split``) the cache holds this
    rank's block of the T slots, and only that block is written; with
    ``cross`` (``stack.kv_split(cache, cross=True)``) the cross K/V hold
    this rank's block of the encoder positions, cut from every
    position's."""
    for name, t in leaves.items():
        if name in ("cross_k", "cross_v") and cross is not None:
            block = cache[name].shape[2]
            cache[name][i] = t[:, cross.rank * block:(cross.rank + 1) * block]
            continue
        if name not in ("k", "v"):
            cache[name][i] = t
            continue
        block = cache[name].shape[2]
        n, lo = (1, 0) if kv is None else (kv.size, kv.rank * block)
        T = block * n
        if ring and S >= T:
            t = torch.roll(t[:, S - T:], (S - T) % T, dims=1)
            cache[name][i] = t[:, lo:lo + block]
        else:
            write = max(0, min(S, T, lo + block) - lo)
            cache[name][i, :, :write] = t[:, lo:lo + write]


def _serve_params(model):
    """(the top-level groups, the decoder's layer hook) for prefill and
    decode: inside a manual region, the groups with their batch-sharded
    leaves gathered and a hook that gathers a layer's
    (``stack.manual_layer_hook``; an encdec decoder layer's with its
    cross-attention), in the compute dtype, as ``repro``'s ``_serve_wrap``
    gathers them; else the model's own groups and no hook.  An encoder's
    stack takes its own hook inside ``stack.run_stack``."""
    ctx = current_ctx()
    if ctx is None or not ctx.manual:
        return model.top_params(), None
    cfg = model.cfg
    top = dp_shard.gather_params(model.top_params(),
                                 top_axes(model.param_specs(cfg)),
                                 compute_dtype=ll.COMPUTE_DTYPE)
    return top, stk.manual_layer_hook(cfg, cross=bool(cfg.encoder_layers),
                                      compute_dtype=ll.COMPUTE_DTYPE)


def _next_token_loss(model, batch, remat_policy: str, params):
    """The loss of either model class: mean cross-entropy of
    ``model.final_hidden``'s unembedding against ``batch["targets"]``
    where ``loss_mask`` (default all ones) is 1, plus the aux loss.
    ``params``: the top-level groups to use (``top_params`` by default).
    Under sequence parallelism (``stack.sp_split``) the hidden states are
    this rank's block of the tokens, gathered by the unembedding."""
    params = params or model.top_params()
    seq = stk.sp_split(model.cfg, batch["tokens"].shape[1])
    x, aux = model.final_hidden(batch, remat_policy=remat_policy,
                                params=params, seq=seq)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(batch["targets"].shape, dtype=torch.float32,
                          device=x.device)
    ce_sum, denom = ll.unembed_xent(params["embed"], model.cfg, x,
                                    batch["targets"], mask, seq=seq)
    loss = ce_sum / denom + aux
    return loss, {"loss": loss, "aux_loss": aux, "tokens": mask.sum()}


class DecoderLM(nn.Module):
    """Decoder-only LM, dense, MoE or SSM.  ``params`` is a tree with the JAX
    package's layout and fp32 leaves (``init_params`` or
    ``convert.from_jax_params``), or with ``plan`` each leaf this rank's
    shard under it (``init_sharded_params``)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], *, device,
                 trainable: bool = False, plan=None):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.trainable = trainable
        self.plan = plan
        specs = self.param_specs(cfg)
        _check_tree(specs, params)
        self.embed = _param_dict(specs["embed"], params["embed"], self.device,
                                 trainable=trainable, prefix="embed",
                                 plan=plan)
        self.final_norm = _param_dict(specs["final_norm"],
                                      params["final_norm"], self.device,
                                      trainable=trainable,
                                      prefix="final_norm", plan=plan)
        self.layers = _layer_list(specs["layers"], params["layers"],
                                  cfg.num_layers, self.device, trainable,
                                  plan=plan)
        if "meta_tokens" in specs:
            self.meta_tokens = _param(
                "meta_tokens", specs["meta_tokens"], params["meta_tokens"],
                self.device, trainable=trainable,
                shape=_shape(plan, "meta_tokens", specs["meta_tokens"],
                             False))
        if "patch_proj" in specs:
            self.patch_proj = _param_dict(specs["patch_proj"],
                                          params["patch_proj"], self.device,
                                          trainable=trainable,
                                          prefix="patch_proj", plan=plan)

    @staticmethod
    def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
        p = {"embed": ll.embed_specs(cfg),
             "layers": stk.stack_param_specs(cfg),
             "final_norm": ll.norm_specs(cfg)}
        if cfg.num_meta_tokens:
            p["meta_tokens"] = spec((cfg.num_meta_tokens, cfg.d_model),
                                    (None, "embed"), scale=0.02)
        if cfg.num_patches:
            p["patch_proj"] = {
                "w": spec((cfg.patch_embed_dim, cfg.d_model),
                          (None, "embed")),
                "b": spec((cfg.d_model,), ("embed",), init="zeros"),
            }
        return p

    def top_params(self) -> Dict[str, Any]:
        """The parameter groups outside the layer stack, by name: what
        the data-parallel step gathers before the loss
        (``dp_shard.gather_params``) and passes back as ``params``."""
        top = {"embed": self.embed, "final_norm": self.final_norm}
        for name in ("meta_tokens", "patch_proj"):
            if hasattr(self, name):
                top[name] = getattr(self, name)
        return top

    @property
    def prefix_len(self) -> int:
        """Internal positions before the text: the meta tokens and the
        patches (counted whether or not a batch carries them, as
        ``repro``'s ``_prefix_len``)."""
        return self.cfg.num_meta_tokens + self.cfg.num_patches

    def _compose_input(self, batch, params=None, seq=None):
        """The embedded tokens with the patch embeddings (vlm, when the
        batch has ``patch_embeds`` (B, P, patch_embed_dim)) and then the
        meta tokens (hybrid) in front, from ``params`` (``top_params`` by
        default).  Returns (x, positions 0 .. S_internal - 1, prefix): the
        prefix the text starts after.  With ``seq`` (``stack.sp_split``,
        never with a prefix) x is this rank's block of the tokens, the
        positions the whole sequence's."""
        cfg = self.cfg
        top = params or self.top_params()
        x = ll.embed(top["embed"], cfg, batch["tokens"], seq=seq)
        B = x.shape[0]
        prefix = 0
        if cfg.num_patches and "patch_embeds" in batch:
            proj = top["patch_proj"]
            pe = ll.cast(batch["patch_embeds"]) @ ll.cast(proj["w"])
            x = torch.cat([pe + ll.cast(proj["b"]), x], dim=1)
            prefix += cfg.num_patches
        if cfg.num_meta_tokens:
            meta = ll.cast(top["meta_tokens"])[None].expand(
                B, cfg.num_meta_tokens, cfg.d_model)
            x = torch.cat([meta, x], dim=1)
            prefix += cfg.num_meta_tokens
        S = batch["tokens"].shape[1] if seq is not None else x.shape[1]
        return x, _arange_positions(B, S, x.device), prefix

    def final_hidden(self, batch, *, remat_policy: str = "none",
                     params=None, seq=None):
        """One full-sequence forward of ``batch`` through the stack and
        the final norm, with no cache; ``params``: the top-level groups
        to use (``top_params`` by default).  Returns (the text positions'
        hidden states (B,S,d_model), the prefix cut; the layers' summed
        aux loss).  With ``seq`` (``stack.sp_split``) the residual stream
        and the hidden states returned are this rank's block of the
        tokens, (B,S/n,d_model): the final norm runs on the block."""
        cfg = self.cfg
        top = params or self.top_params()
        x, positions, prefix = self._compose_input(batch, top, seq)
        x, aux = stk.run_stack(self.layers, cfg, x, positions=positions,
                               causal=True, remat_policy=remat_policy,
                               seq=seq)
        return ll.norm(top["final_norm"], x, cfg)[:, prefix:], aux

    def loss(self, batch, *, remat_policy: str = "dots", params=None):
        """Mean next-token cross-entropy over ``batch`` ({"tokens",
        "targets", optional "loss_mask"}, (B,S) each, and for the vlm
        family optional "patch_embeds"), plus the layers' summed MoE
        load-balancing loss (``metrics["aux_loss"]``, 0 for the other
        families).  The prefix is cut before the unembedding.
        ``params``: the top-level groups to use in place of the model's
        own (the data-parallel step's gathered ones).  Returns (loss,
        metrics)."""
        return _next_token_loss(self, batch, remat_policy, params)

    def init_cache(self, batch: int, max_len: int,
                   kv_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
        """The decode cache for ``max_len`` text positions: K/V as long as
        ``max_len + prefix_len``, this rank's block of them under rules
        that cut it over the model ranks (``stack.init_cache``)."""
        return stk.init_cache(self.cfg, batch, max_len + self.prefix_len,
                              device=self.device, kv_dtype=kv_dtype)

    @torch.no_grad()
    def prefill(self, batch, cache):
        """Run the prompt (with its prefix), fill the cache, return
        last-position logits (B,1,V).  Each layer's cache leaves (K/V and
        the SSM's conv tail and final state) are collected in the same
        pass over the layers and written into ``cache`` in place; the
        cache is also returned.  A ring cache of T slots keeps the
        prompt's last T positions, rolled so position p sits in slot
        p % T, as ``repro``'s prefill does; a cache cut over the model
        ranks (``stack.kv_split``) takes this rank's block of those
        slots."""
        cfg = self.cfg
        top, hook = _serve_params(self)
        x, positions, _ = self._compose_input(batch, top)
        S = x.shape[1]
        ring = stk.use_ring_cache(cfg)
        kv = stk.kv_split(cache)
        for i, (p, is_global) in enumerate(zip(self.layers,
                                               stk.global_flags(cfg))):
            x, _, leaves = stk.block(p if hook is None else hook(p), cfg, x,
                                     positions=positions,
                                     is_global=is_global, ssm_state=True)
            _store_leaves(cache, i, leaves, S, ring, kv)
        h = ll.norm(top["final_norm"], x[:, -1], cfg)   # rows are independent
        return ll.unembed(top["embed"], cfg, h[:, None]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, positions):
        """tokens: (B,1); positions: (B,) text positions (unused by the SSM
        family), offset here by ``prefix_len``.  Writes this step's K/V
        (slot ``position % T`` of a ring cache) and each SSM layer's conv
        tail and state into ``cache`` in place.  Returns (logits,
        cache)."""
        cfg = self.cfg
        top, hook = _serve_params(self)
        x = ll.embed(top["embed"], cfg, tokens)
        positions = positions + self.prefix_len
        kv = stk.kv_split(cache)
        for i, (p, is_global) in enumerate(zip(self.layers,
                                               stk.global_flags(cfg))):
            layer_cache = {name: t[i] for name, t in cache.items()}
            x = stk.decode_block(p if hook is None else hook(p), cfg, x,
                                 layer_cache, positions=positions,
                                 is_global=is_global, kv=kv)
        x = ll.norm(top["final_norm"], x, cfg)
        return ll.unembed(top["embed"], cfg, x), cache


def _arange_positions(B: int, S: int, device):
    """Positions 0 .. S-1 of each of B rows: (B,S)."""
    return torch.arange(S, device=device)[None].expand(B, S)


def _sinusoidal(positions, d: int):
    """positions (B,S) -> (B,S,d) fp32 fixed sinusoids, [sin | cos], as
    ``repro``'s: the frequencies are computed in float64 and rounded to
    fp32, the angles in fp32."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float64,
                                     device=positions.device)
                      / max(half - 1, 1)).float()
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecLM(nn.Module):
    """Whisper-style encoder-decoder.  The audio conv frontend is a stub:
    a batch carries frame embeddings ``frames`` (B, max_source_positions,
    d_model).  ``params`` has the JAX package's layout (``embed``, the
    stacked ``encoder`` of ``encoder_layers``, ``enc_norm``, the stacked
    decoder ``layers`` with cross-attention, ``final_norm``) and fp32
    leaves, or with ``plan`` each leaf this rank's shard under it, as
    ``DecoderLM``'s.  Positions are sinusoids added to the input (no
    rotary).

    Prefill runs the encoder once and each decoder layer once: the cross
    K/V a layer attends over are the ones it writes into the cache, so
    they are projected once where ``repro`` projects them twice (inside
    the layer and again to fill the cache; the values are equal).  Decode
    reads them back rounded to the cache's dtype, as ``repro``'s does.

    Under a model axis both stacks split attention (cross-attention too)
    by heads and the MLP by d_ff; in training each stack takes ``seq_res``
    on its own length (``stack.sp_split``: the encoder over the frames,
    the decoder over the tokens), and the encoder's output is gathered
    whole once for every decoder layer's cross-attention
    (``layers.cross_source``).  Under the serving rules the cross K/V
    cache holds a block of the encoder positions a rank
    (``Cache.cross_shards``)."""

    prefix_len = 0

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], *, device,
                 trainable: bool = False, plan=None):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.trainable = trainable
        self.plan = plan
        specs = self.param_specs(cfg)
        _check_tree(specs, params)
        for name in ("embed", "enc_norm", "final_norm"):
            setattr(self, name, _param_dict(specs[name], params[name],
                                            self.device,
                                            trainable=trainable,
                                            prefix=name, plan=plan))
        self.encoder = _layer_list(specs["encoder"], params["encoder"],
                                   cfg.encoder_layers, self.device, trainable,
                                   prefix="encoder", plan=plan)
        self.layers = _layer_list(specs["layers"], params["layers"],
                                  cfg.num_layers, self.device, trainable,
                                  plan=plan)

    @staticmethod
    def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
        return {"embed": ll.embed_specs(cfg),
                "encoder": stk.stack_param_specs(cfg, cfg.encoder_layers),
                "enc_norm": ll.norm_specs(cfg),
                "layers": stk.stack_param_specs(cfg, cross=True),
                "final_norm": ll.norm_specs(cfg)}

    def top_params(self) -> Dict[str, Any]:
        """The parameter groups outside the two layer stacks, by name."""
        return {"embed": self.embed, "enc_norm": self.enc_norm,
                "final_norm": self.final_norm}

    def encode(self, frames, params=None, seq=None):
        """frames (B, T_src, d_model) -> the encoder's output (B, T_src,
        d_model) in the compute dtype: sinusoids added, the non-causal
        stack (never rematerialised), ``enc_norm`` (from ``params``,
        ``top_params`` by default).  With ``seq`` (``stack.sp_split`` of
        T_src) the stack and ``enc_norm`` run on this rank's block of the
        positions, and the block is returned."""
        top = params or self.top_params()
        pos = _arange_positions(*frames.shape[:2], frames.device)
        x = ll.cast(frames) + ll.cast(_sinusoidal(pos, self.cfg.d_model))
        if seq is not None:
            x = model_axis.scatter_seq(x, seq, summed=False)
        x, _ = stk.run_stack(self.encoder, self.cfg, x, positions=pos,
                             causal=False, seq=seq)
        return ll.norm(top["enc_norm"], x, self.cfg)

    def _embed_dec(self, tokens, positions, params=None, seq=None):
        """The decoder's input: the lookup plus the sinusoids of
        ``positions`` (B, S); with ``seq`` this rank's block of the
        tokens."""
        top = params or self.top_params()
        x = ll.embed(top["embed"], self.cfg, tokens, seq=seq)
        if seq is not None:
            n = positions.shape[1] // seq.size
            positions = positions[:, seq.rank * n:(seq.rank + 1) * n]
        return x + _sinusoidal(positions, self.cfg.d_model).to(x.dtype)

    def final_hidden(self, batch, *, remat_policy: str = "none",
                     params=None, seq=None):
        """One full-sequence forward of ``batch`` ({"frames", "tokens"}):
        the encoder (never rematerialised), the decoder under
        ``remat_policy`` attending over its output, the final norm, with
        no cache; ``params``: the top-level groups to use (``top_params``
        by default).  Returns (hidden states (B,S,d_model), aux loss 0).
        With ``seq`` (``stack.sp_split`` of the tokens) the decoder's
        residual stream and the hidden states returned are this rank's
        block of the tokens; the encoder takes its own split of the frames
        (``stack.sp_split`` of T_src), and its output is gathered whole
        for the cross-attention (``layers.cross_source``)."""
        cfg = self.cfg
        top = params or self.top_params()
        frames = batch["frames"]
        enc_seq = stk.sp_split(cfg, frames.shape[1])
        enc = ll.cross_source(self.encode(frames, top, enc_seq), enc_seq)
        pos = _arange_positions(*batch["tokens"].shape, enc.device)
        x = self._embed_dec(batch["tokens"], pos, top, seq)
        x, aux = stk.run_stack(self.layers, cfg, x, positions=pos,
                               causal=True, remat_policy=remat_policy,
                               enc_out=enc, seq=seq)
        return ll.norm(top["final_norm"], x, cfg), aux

    def loss(self, batch, *, remat_policy: str = "dots", params=None):
        """Mean next-token cross-entropy over ``batch`` ({"frames",
        "tokens", "targets", optional "loss_mask"}); the decoder runs
        under ``remat_policy``, the encoder without remat, as ``repro``'s.
        ``params``: as ``DecoderLM.loss``.  Returns (loss, metrics),
        ``aux_loss`` 0."""
        return _next_token_loss(self, batch, remat_policy, params)

    def init_cache(self, batch: int, max_len: int,
                   kv_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
        """Self K/V for ``max_len`` positions and the cross K/V over
        ``max_source_positions``, each in ``kv_dtype``; under rules that
        cut them over the model ranks, this rank's blocks
        (``stack.init_cache``)."""
        return stk.init_cache(self.cfg, batch, max_len, device=self.device,
                              kv_dtype=kv_dtype)

    @torch.no_grad()
    def prefill(self, batch, cache):
        """Encode ``batch["frames"]``, run the prompt ``batch["tokens"]``
        through the decoder, write each layer's self K/V (up to the
        cache's length) and cross K/V into ``cache`` in place, and return
        the last position's logits (B,1,V) and the cache.  A cache cut
        over the model ranks (``stack.kv_split``) takes this rank's block
        of the self K/V slots and of every kv head's cross K/V
        positions."""
        cfg = self.cfg
        top, hook = _serve_params(self)
        enc = ll.cross_source(self.encode(batch["frames"], top))
        pos = _arange_positions(*batch["tokens"].shape, enc.device)
        x = self._embed_dec(batch["tokens"], pos, top)
        kv, cross = stk.kv_split(cache), stk.kv_split(cache, cross=True)
        for i, p in enumerate(self.layers):
            x, _, leaves = stk.block(p if hook is None else hook(p), cfg, x,
                                     positions=pos, is_global=False,
                                     ssm_state=True, enc_out=enc)
            _store_leaves(cache, i, leaves, x.shape[1], ring=False, kv=kv,
                          cross=cross)
        h = ll.norm(top["final_norm"], x[:, -1], cfg)    # rows are independent
        return ll.unembed(top["embed"], cfg, h[:, None]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, positions):
        """tokens (B,1), positions (B,): one step, this step's self K/V
        written into ``cache`` in place.  Returns (logits, cache)."""
        cfg = self.cfg
        top, hook = _serve_params(self)
        x = self._embed_dec(tokens, positions[:, None], top)
        kv, cross = stk.kv_split(cache), stk.kv_split(cache, cross=True)
        for i, p in enumerate(self.layers):
            layer_cache = {name: t[i] for name, t in cache.items()}
            x = stk.decode_block(p if hook is None else hook(p), cfg, x,
                                 layer_cache, positions=positions,
                                 is_global=False, kv=kv, cross=cross)
        x = ll.norm(top["final_norm"], x, cfg)
        return ll.unembed(top["embed"], cfg, x), cache


def model_class(cfg: ModelConfig):
    """The model class of ``cfg``'s family."""
    return EncDecLM if cfg.family == "encdec" else DecoderLM


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The spec tree of ``cfg``'s model, in the JAX package's layout."""
    return model_class(cfg).param_specs(cfg)


def build_model(cfg: ModelConfig, params: Dict[str, Any], *, device,
                trainable: bool = False, plan=None):
    """The model for ``cfg``: ``EncDecLM`` for the encdec family, else
    ``DecoderLM``; with ``plan``, ``params``' leaves are this rank's shards
    under it (``init_sharded_params``)."""
    return model_class(cfg)(cfg, params, device=device, trainable=trainable,
                            plan=plan)
