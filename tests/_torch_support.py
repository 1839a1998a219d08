"""Shared helpers for the PyTorch port's tests (``test_torch_*.py``).

Inputs are made from a seed with numpy and handed to both packages; model
parameters are drawn by the JAX package and carried into the port with
``repro_torch.models.convert.from_jax_params``.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import torch

# The tensors here are tiny; one intra-op thread keeps these tests from
# competing for cores with the wall-clock tests running beside them.
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rand(seed: int, shape, dtype: str = "float32"):
    """The same standard-normal array for both frameworks:
    returns (jax array, torch tensor) in ``dtype``."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def as_f32(x) -> np.ndarray:
    """A JAX array or torch tensor of any float type as a float32 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def jax_and_port(arch: str, seed: int = 0):
    """Reduced ``arch`` in both packages with the same parameters:
    (jax model, jax params, port model on the CPU, reduced config)."""
    from repro.configs import get_config, reduced
    from repro.models import build_model
    from repro_torch.configs import get_config as port_get_config
    from repro_torch.configs import reduced as port_reduced
    from repro_torch.models.convert import from_jax_params

    cfg = reduced(get_config(arch))
    jmodel = build_model(cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = from_jax_params(port_reduced(port_get_config(arch)), tree,
                           device="cpu")
    return jmodel, params, port, cfg


def long_tensor(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long)
