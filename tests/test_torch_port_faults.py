"""Two faults of the port against the JAX package, each held here:

* the flash kernel refused head dim 96, which phi-3-vision's attention
  uses: every head dim of a config whose family has attention must pass
  the wrapper's checks, and the CUDA source must instantiate it on every
  forward kernel and in the shared-memory size query;
* ``machine_fingerprint()`` counted 0 devices on a host with no card where
  ``repro`` counts 1 (JAX's CPU device), so a ``DPTCache`` entry written
  by one package missed in the other.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import as_f32, rand
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.configs import get_config, list_configs
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

ATTENTION_ARCHS = [a for a in list_configs() if get_config(a).uses_attention]


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_torch_flash_takes_every_attention_head_dim(arch):
    D = get_config(arch).head_dim
    q = torch.zeros((1, 8, 4, D), dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 2, D), dtype=torch.bfloat16)
    fa._check(q, kv, kv)


def test_torch_flash_source_instantiates_head_dim_96():
    """96 = 6 x 16 runs on the tensor-core kernels: the scalar launch, the
    wgmma and decode launches and the shared-memory and attribute queries
    (FWD_TC) all name it, and a bf16 call at 96 is sent to them."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert "flash_fwd_kernel<T, 96>" in src
    assert "launch_fwd_wgmma<96>" in src
    assert "launch_fwd_decode<96>" in src
    assert "FWD_TC(96)" in src
    assert 96 in fa.HEAD_DIMS and 40 not in fa.HEAD_DIMS
    assert fa.forward_variant(1088, 1088, 32, 32, 96, torch.bfloat16,
                              True) == "wgmma"
    assert fa.forward_variant(1, 1088, 32, 32, 96, torch.bfloat16,
                              True) == "decode"


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_torch_flash_head_dim_96_matches_jax(causal, window):
    """phi-3-vision's head dim through the port's attention (the plain twin
    on the CPU) against ``repro``'s Pallas kernel in interpret mode; fp32,
    atol / rtol 2e-5 as test_torch_kernels.py holds flash."""
    jq, tq = rand(0, (1, 48, 4, 96))
    jk, tk = rand(1, (1, 48, 2, 96))
    jv, tv = rand(2, (1, 48, 2, 96))
    out = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    ref = jflash(jq, jk, jv, causal=causal, window=window, block_q=16,
                 block_k=16, interpret=True)
    np.testing.assert_allclose(as_f32(out), as_f32(ref), atol=2e-5,
                               rtol=2e-5)


def test_torch_machine_fingerprint_matches_repro_without_a_card():
    """With jax on the CPU (one device) and no card, both packages key a
    machine alike."""
    import jax

    from repro.utils.fingerprint import machine_fingerprint as jfp
    from repro_torch.utils.fingerprint import machine_fingerprint as tfp
    assert jax.local_device_count() == 1
    if torch.cuda.device_count() == 0:
        assert tfp() == jfp()
    assert tfp(device_count=3) == jfp(device_count=3)
    assert tfp() == tfp(device_count=max(1, torch.cuda.device_count()))
