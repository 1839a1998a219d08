"""DecoderLM for the dense, MoE and SSM families: training loss, prefill,
decode step and cache.

The counterpart of ``repro/models/lm.py`` (``cross_entropy``,
``DecoderLM``, ``build_model``) for dense configs (qwen2-0.5b, qwen3-1.7b,
yi-34b, mistral-large-123b), the MoE family (granite-moe-3b-a800m,
mixtral-8x22b, whose windowed layers decode over a ring cache) and the
SSM family (mamba2-780m), in training and in serving (a K/V cache for the
families with attention, the conv tail and SSD state for the SSM family).
The model is an ``nn.Module`` holding its parameters: a ``ModuleList`` of
per-layer parameter dicts where JAX scans over stacked leaves.  Other
families (hybrid, encdec, vlm) raise ``NotImplementedError``.

Two ways to hold the parameters:
* serving (``trainable=False``): cast once at load to the compute dtype,
  except the leaves JAX uses in fp32, with no gradients;
* training (``trainable=True``): fp32 masters with ``requires_grad``, cast
  at each use as JAX casts them, so the gradients land on the masters.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import stack as stk
from repro_torch.models.module import ParamSpec

# leaves JAX uses uncast (fp32) at every use: the norm scales and the SSM's
# dt_bias, A_log and gate_norm
_FP32_LEAVES = frozenset({"scale", "q_norm", "k_norm"}) | ssm_mod.FP32_LEAVES


def cross_entropy(logits, targets, mask):
    """fp32 cross-entropy (logsumexp, no z-loss) averaged over the tokens
    where mask (B,S) is 1."""
    ce_sum, denom = ll.xent_sum(logits, targets, mask)
    return ce_sum / denom


def _param_dict(specs: Dict[str, ParamSpec], values, device, index=None,
                trainable: bool = False):
    """A ParameterDict of one layer's (or one top-level group's) leaves,
    checked against the spec and moved to ``device``: fp32 masters that
    take gradients if ``trainable``, else cast once to the compute dtype,
    except the leaves JAX keeps in fp32."""
    if set(values) != set(specs):
        raise ValueError(f"parameter tree mismatch: expected "
                         f"{sorted(specs)}, got {sorted(values)}")
    out = {}
    for name, s in specs.items():
        t = values[name]
        if index is not None:
            t = t[index]
        shape = s.shape[1:] if index is not None else s.shape
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"parameter {name}: shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        dtype = torch.float32 if trainable or name in _FP32_LEAVES \
            else ll.COMPUTE_DTYPE
        out[name] = nn.Parameter(t.to(device=device, dtype=dtype).contiguous(),
                                 requires_grad=trainable)
    return nn.ParameterDict(out)


class DecoderLM(nn.Module):
    """Decoder-only LM, dense, MoE or SSM.  ``params`` is a tree with the JAX
    package's layout and fp32 leaves (``init_params`` or
    ``convert.from_jax_params``)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], *, device,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.trainable = trainable
        specs = self.param_specs(cfg)
        self.embed = _param_dict(specs["embed"], params["embed"], self.device,
                                 trainable=trainable)
        self.final_norm = _param_dict(specs["final_norm"],
                                      params["final_norm"], self.device,
                                      trainable=trainable)
        self.layers = nn.ModuleList(
            nn.ModuleDict({group: _param_dict(s, params["layers"][group],
                                              self.device, index=i,
                                              trainable=trainable)
                           for group, s in specs["layers"].items()})
            for i in range(cfg.num_layers))

    @staticmethod
    def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
        return {"embed": ll.embed_specs(cfg),
                "layers": stk.stack_param_specs(cfg),
                "final_norm": ll.norm_specs(cfg)}

    def loss(self, batch, *, remat_policy: str = "dots"):
        """Mean next-token cross-entropy over ``batch`` ({"tokens",
        "targets", optional "loss_mask"}, (B,S) each), plus the layers'
        summed MoE load-balancing loss (``metrics["aux_loss"]``, 0 for the
        other families).  Returns (loss, metrics)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = ll.embed(self.embed, cfg, tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x, aux = stk.run_stack(self.layers, cfg, x, positions=positions,
                               causal=True, remat_policy=remat_policy)
        x = ll.norm(self.final_norm, x, cfg)
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(batch["targets"].shape, dtype=torch.float32,
                              device=tokens.device)
        ce_sum, denom = ll.unembed_xent(self.embed, cfg, x, batch["targets"],
                                        mask)
        loss = ce_sum / denom + aux
        return loss, {"loss": loss, "aux_loss": aux, "tokens": mask.sum()}

    def init_cache(self, batch: int, max_len: int,
                   kv_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
        return stk.init_cache(self.cfg, batch, max_len, device=self.device,
                              kv_dtype=kv_dtype)

    @torch.no_grad()
    def prefill(self, batch, cache):
        """Run the prompt, fill the cache, return last-position logits
        (B,1,V).  Each layer's cache leaves (K/V, or the SSM's conv tail and
        final state) are collected in the same pass over the layers and
        written into ``cache`` in place; the cache is also returned.  A
        ring cache of T slots keeps the prompt's last T positions, rolled
        so position p sits in slot p % T, as ``repro``'s prefill does."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = ll.embed(self.embed, cfg, tokens)
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        ring = stk.use_ring_cache(cfg)
        for i, p in enumerate(self.layers):
            x, _, leaves = stk.block(p, cfg, x, positions=positions,
                                     ssm_state=True)
            for name, t in leaves.items():
                if name not in ("k", "v"):
                    cache[name][i] = t
                    continue
                T = cache[name].shape[2]
                if ring and S >= T:
                    cache[name][i] = torch.roll(t[:, S - T:], (S - T) % T,
                                                dims=1)
                else:
                    write = min(S, T)
                    cache[name][i, :, :write] = t[:, :write]
        h = ll.norm(self.final_norm, x[:, -1], cfg)      # rows are independent
        return ll.unembed(self.embed, cfg, h[:, None]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, positions):
        """tokens: (B,1); positions: (B,) absolute positions (unused by the
        SSM family).  Writes this step's K/V (slot ``position % T`` of a
        ring cache), or each SSM layer's conv tail and state, into
        ``cache`` in place.  Returns (logits, cache)."""
        cfg = self.cfg
        x = ll.embed(self.embed, cfg, tokens)
        for i, p in enumerate(self.layers):
            layer_cache = {name: t[i] for name, t in cache.items()}
            x = stk.decode_block(p, cfg, x, layer_cache, positions=positions)
        x = ll.norm(self.final_norm, x, cfg)
        return ll.unembed(self.embed, cfg, x), cache


def build_model(cfg: ModelConfig, params: Dict[str, Any], *, device,
                trainable: bool = False) -> DecoderLM:
    """The model for ``cfg``; families other than dense, MoE and SSM raise
    ``NotImplementedError``."""
    return DecoderLM(cfg, params, device=device, trainable=trainable)
