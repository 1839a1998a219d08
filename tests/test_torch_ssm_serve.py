"""The port's SSM serving path on the CPU against the JAX package: the
prefill scan with its final state, the one-token recurrence, the mixer's
decode, reduced mamba2-780m's prefill / decode through ``DecoderLM`` and
greedy generation through the engine.

Inputs are made from a seed with numpy; model parameters are ``repro``'s,
carried across by ``from_jax_params``.  fp32 compute (tests/conftest.py).
Tolerances: the SSD scans sum the chunked form in another order than
``repro``'s jnp oracle, so y and the state are held to atol 1e-4 / rtol
1e-3 as tests/test_torch_ssm.py holds the scan; the step, the mixer and the
logits, which differ only by rounding order over 2 layers, to 1e-5 / 1e-4.
The conv tail is bf16 in both packages and is held to one bf16 ulp (2^-7
relative), as test_torch_models.py holds the K/V cache: its fp32 inputs
differ by summation order and one that sits on a rounding boundary rounds
to the neighbouring bf16 value.  On a CUDA tensor ``ops.ssd_prefill``
launches the kernel; that runs only on the card (``chip_smoke.py``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import as_f32, jax_and_port, long_tensor, rand
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import ssm as tssm
from repro_torch.models import stack as tstack

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-780m"


def _close(out, expect, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(as_f32(out), as_f32(expect), atol=atol,
                               rtol=rtol)


def _close_bf16(out, expect):
    assert out.dtype == torch.bfloat16
    _close(out, expect, atol=1e-6, rtol=2 ** -7)


def ssd_inputs(b, s, h, p, g, n):
    """dt = softplus(N(0,1)), A = -exp(N(0,1) / 2), as the kernel tests."""
    jx, tx = rand(0, (b, s, h, p))
    jdt_raw, _ = rand(1, (b, s, h))
    jA_raw, _ = rand(2, (h,))
    jB, tB = rand(3, (b, s, g, n))
    jC, tC = rand(4, (b, s, g, n))
    jdt = jax.nn.softplus(jdt_raw)
    jA = -jnp.exp(jA_raw * 0.5)
    tdt = torch.tensor(np.asarray(jdt, np.float32))
    tA = torch.tensor(np.asarray(jA, np.float32))
    return (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC)


@pytest.fixture(scope="module")
def pair():
    return jax_and_port(ARCH)


# ---- the kernels' entry points ---------------------------------------------

@pytest.mark.parametrize("s,chunk", [(64, 16), (37, 16), (300, 256)])
def test_torch_ssd_prefill_matches_jax(s, chunk):
    """y and the final state at a chunk multiple and at padded lengths
    (300 with chunk 256 pads to 512, as the serving prompts do)."""
    jin, tin = ssd_inputs(2, s, 4, 8, 2, 8)
    jy, jstate = jops.ssd_prefill(*jin, chunk=chunk)
    ty, tstate = ops.ssd_prefill(*tin, chunk=chunk)
    assert ty.shape == tin[0].shape and tstate.dtype == torch.float32
    assert tuple(tstate.shape) == (2, 4, 8, 8)
    _close(ty, jy, atol=1e-4, rtol=1e-3)
    _close(tstate, jstate, atol=1e-4, rtol=1e-3)


def test_torch_ssd_prefill_state_is_the_sequential_state():
    """The padded prompt's state is the recurrence's state after its last
    real token: the padding neither decays nor feeds it."""
    jin, tin = ssd_inputs(1, 37, 4, 8, 1, 8)
    _, naive_state = jref.ssd_naive(*jin)
    _, state = ops.ssd_prefill(*tin, chunk=16)
    _close(state, naive_state, atol=1e-4, rtol=1e-3)


def test_torch_ssd_step_matches_jax():
    b, h, p, g, n = 3, 4, 8, 2, 8
    jstate, tstate = rand(5, (b, h, p, n))
    jx, tx = rand(6, (b, h, p))
    jdt_raw, _ = rand(7, (b, h))
    jA_raw, _ = rand(8, (h,))
    jB, tB = rand(9, (b, g, n))
    jC, tC = rand(10, (b, g, n))
    jdt = jax.nn.softplus(jdt_raw)
    jA = -jnp.exp(jA_raw * 0.5)
    tdt = torch.tensor(np.asarray(jdt, np.float32))
    tA = torch.tensor(np.asarray(jA, np.float32))
    jy, jnew = jref.ssd_step(jstate, jx, jdt, jA, jB, jC)
    for fn in (ref.ssd_step, ops.ssd_step):
        ty, tnew = fn(tstate, tx, tdt, tA, tB, tC)
        assert ty.dtype == tx.dtype and tnew.dtype == torch.float32
        _close(ty, jy)
        _close(tnew, jnew)


def test_torch_ssd_state_cpu_path_counts_no_launch():
    """On the CPU the state entry takes its plain twin and counts nothing,
    as ``ssd_scan`` does."""
    _, tin = ssd_inputs(1, 16, 2, 8, 1, 4)
    ss.ssd_scan.launches = 0
    y, state = ss.ssd_scan_state(*tin, chunk=8)
    y_plain, state_plain = ss.ssd_scan_state_plain(*tin, chunk=8)
    assert torch.equal(y, y_plain) and torch.equal(state, state_plain)
    assert ss.ssd_scan.launches == 0


def test_torch_ssd_state_launch_counts_and_passes_its_buffer(monkeypatch):
    """A launch through the state entry counts one ``ssd_scan`` launch,
    like a y-only launch, and hands the C entry its own contiguous fp32
    (b, h, p, n) state buffer.  The C entry is stubbed (no card here): the
    stub writes the plain twin's results where the kernel writes them."""
    calls = []

    def fake_call(entry, x, dt, A, B, C, y, cum, states, chunk, final=None):
        calls.append((entry, final))
        y_ref, state_ref = ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)
        y.copy_(y_ref)
        if final is not None:
            final.copy_(state_ref)

    monkeypatch.setattr(ss, "_call", fake_call)
    _, tin = ssd_inputs(1, 16, 2, 8, 1, 4)
    ss.ssd_scan.launches = 0
    y, state = ss._launch(*tin, 8, with_state=True)
    y_only = ss._launch(*tin, 8)
    assert ss.ssd_scan.launches == 2
    (e1, final), (e2, none) = calls
    assert e1 == e2 == "ssd_scan_fwd" and none is None
    assert final is state and state.is_contiguous()
    assert tuple(state.shape) == (1, 2, 8, 4) and state.dtype == torch.float32
    _close(state, ref.ssd_chunked(*tin, chunk=8)[1], atol=0, rtol=0)
    assert torch.equal(y, y_only)


def test_torch_ssd_state_refuses_a_gradient_and_other_devices():
    _, (x, dt, A, B, C) = ssd_inputs(1, 16, 2, 8, 1, 4)
    with pytest.raises(NotImplementedError, match="backward"):
        ss.ssd_scan_state(x.requires_grad_(), dt, A, B, C, chunk=8)
    meta = torch.empty((1, 16, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ss.ssd_scan_state(meta, meta[..., 0], meta[0, 0, :, 0],
                          meta[..., :1, :4], meta[..., :1, :4], chunk=8)


# ---- the mixer and the model -------------------------------------------------

def test_torch_ssm_cache_shapes_match_jax(pair):
    from repro.models import stack as jstack
    _, _, port, cfg = pair
    jshapes = jstack.cache_shapes(cfg, 3, 40, ring=False)
    tshapes = tstack.cache_shapes(port.cfg, 3, 40)
    assert set(tshapes) == set(jshapes) == {"ssm_conv", "ssm_state"}
    for k, (shape, dtype) in jshapes.items():
        assert tshapes[k][0] == tuple(shape)
        assert str(tshapes[k][1]).removeprefix("torch.") == jnp.dtype(
            dtype).name
    cache = port.init_cache(3, 40)
    assert cache["ssm_conv"].dtype == torch.bfloat16
    assert cache["ssm_state"].dtype == torch.float32


def test_torch_ssm_decode_matches_jax(pair):
    """One layer's recurrent step on the same cache and input."""
    jmodel, params, port, cfg = pair
    jp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["ssm"])
    tp = port.layers[0]["ssm"]
    shapes = tssm.ssm_cache_shapes(port.cfg, 2)
    jconv, _ = rand(11, shapes["conv"][0], "bfloat16")
    jstate, tstate = rand(12, shapes["state"][0])
    tconv = torch.tensor(np.asarray(jconv.astype(jnp.float32))).to(
        torch.bfloat16)
    jx, tx = rand(13, (2, 1, cfg.d_model))
    jout, jc = jssm.ssm_decode(jp, cfg, jx, {"conv": jconv, "state": jstate})
    tout, tc = tssm.ssm_decode(tp, port.cfg, tx,
                               {"conv": tconv, "state": tstate})
    _close(tout, jout)
    _close_bf16(tc["conv"], jc["conv"])
    _close(tc["state"], jc["state"])


@pytest.mark.parametrize("S", [24, 37])
def test_torch_ssm_prefill_and_decode_match_jax(pair, S):
    """Prefill logits, both cache leaves, then teacher-forced decode logits
    and leaves after each step; S 37 pads the scan (chunk 8)."""
    jmodel, params, port, cfg = pair
    rng = np.random.default_rng(S)
    prompts = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    jcache = jmodel.init_cache(2, 48)
    jl, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(prompts)},
                                jcache)
    tcache = port.init_cache(2, 48)
    tl, tcache = port.prefill({"tokens": long_tensor(prompts)}, tcache)
    for i in range(forced.shape[1] + 1):
        _close(tl, jl)
        _close_bf16(tcache["ssm_conv"], jcache["ssm_conv"])
        _close(tcache["ssm_state"], jcache["ssm_state"], atol=1e-4,
               rtol=1e-3)
        if i == forced.shape[1]:
            break
        pos = np.full((2,), S + i, np.int32)
        jl, jcache = jmodel.decode_step(params, jcache,
                                        jnp.asarray(forced[:, i:i + 1]),
                                        jnp.asarray(pos))
        tl, tcache = port.decode_step(tcache, long_tensor(forced[:, i:i + 1]),
                                      long_tensor(pos))


@pytest.mark.parametrize("S", [2, 24])
def test_torch_ssm_decode_matches_prefill(pair, S):
    """As tests/test_models.py holds every arch: prefill of S-1 tokens and
    one decode step give the last logits of a prefill of all S.  S 2 is
    shorter than the conv tail, whose missing rows are the conv's zeros."""
    _, _, port, cfg = pair
    rng = np.random.default_rng(1)
    tokens = long_tensor(rng.integers(0, cfg.vocab_size, (2, S)))
    full, _ = port.prefill({"tokens": tokens}, port.init_cache(2, S + 8))
    cache = port.init_cache(2, S + 8)
    _, cache = port.prefill({"tokens": tokens[:, :-1]}, cache)
    step, _ = port.decode_step(cache, tokens[:, -1:],
                               torch.full((2,), S - 1, dtype=torch.long))
    a, b = as_f32(full[:, -1]), as_f32(step[:, 0])
    np.testing.assert_allclose(a, b, atol=5e-3 * max(1, np.abs(a).max()),
                               rtol=1e-2)


def test_torch_ssm_greedy_tokens_match_jax_engine(pair):
    """Same params, same prompts: the port's engine on the CPU answers with
    the JAX engine's greedy tokens."""
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro_torch.serve.engine import ServeEngine
    jmodel, params, port, cfg = pair
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (3, 19)).astype(np.int32)
    jtoks = JaxEngine(jmodel, params, max_batch=4,
                      max_len=32).generate(prompts, 6).tokens
    ttoks = ServeEngine(port, max_batch=4, max_len=32,
                        device="cpu").generate(prompts, 6).tokens
    np.testing.assert_array_equal(ttoks, jtoks)


def test_torch_launch_serve_mamba2_prints_json():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--requests", "5",
         "--prompt-len", "11", "--max-new", "3", "--max-batch", "4"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["arch"].startswith(ARCH) and summary["requests"] == 5
    assert summary["tokens_generated"] == 15 and summary["device"] == "cpu"
