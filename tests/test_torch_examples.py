"""The port's ``core/search.py`` shims against ``repro.core.search``, and
the port's examples (``examples/torch_*.py``) run on the CPU at a small
size.

The shims run on each package's simulator over the same profiles, which
is deterministic, so the results must be equal.  The examples run as
their users run them, with ``--device cpu``: each must reach its summary.
The online-tuning flow is also run in-process, where every delivered batch
must equal the host batch of its position byte for byte; whether it
retunes is wall-clock timing on this host, so that is not asserted here
(``chip_smoke.py`` asserts it on the card).
"""
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as jcore
import repro.core.search as jsearch
import repro.data.storage as jstorage
import repro_torch.core as tcore
import repro_torch.data.storage as tstorage
from _torch_support import same_bytes

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _shim(core, storage, search, name):
    profile = storage.coco_profile(160)
    machine = core.MachineProfile()
    cfg = core.DPTConfig(num_cpu_cores=8, num_devices=1, max_prefetch=4,
                         num_batches=24, epoch=0)
    if name == "cost_model_warmstart":
        return search.cost_model_warmstart(profile, machine, batch_size=32,
                                           config=cfg)
    ev = core.SimulatorEvaluator(core.LoaderSimulator(profile, machine),
                                 batch_size=32)
    if name == "successive_halving":
        return search.successive_halving(ev, config=cfg)
    if name == "coordinate_hillclimb":
        return search.coordinate_hillclimb(ev, start=(2, 1), config=cfg)
    if name == "tuned_with_warmstart":
        return search.tuned_with_warmstart(ev, profile, machine,
                                           batch_size=32, config=cfg)
    return search.goodput_tune(ev, step_time_s=0.05, num_batches=16,
                               config=cfg)


@pytest.mark.parametrize("name", ["successive_halving", "coordinate_hillclimb",
                                  "tuned_with_warmstart", "goodput_tune",
                                  "cost_model_warmstart"])
def test_torch_search_shim_matches_repro(name):
    port = _shim(tcore, tstorage, tcore.search, name)
    ref = _shim(jcore, jstorage, jsearch, name)
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _run(script, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, str(EXAMPLES / script),
                          "--device", "cpu", *args], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("script,args,summary", [
    ("torch_quickstart.py", ["--items", "64", "--resolution", "16",
                             "--cores", "2", "--batches", "2"],
     "delivered 2 batches to cpu"),
    ("torch_tune_dataloader.py", ["--items", "64"], "live loader"),
    ("torch_online_tuning.py", ["--steps", "40", "--drift-at", "10",
                                "--items", "256"], "completed hot swaps="),
    ("torch_serve_batched.py", ["--arch", "mamba2-780m", "--new-tokens", "4",
                                "--clients", "3"],
     "frontend served 3 concurrent requests"),
])
def test_torch_example_runs_on_the_cpu(script, args, summary):
    out = _run(script, *args)
    assert summary in out, out


def test_torch_examples_import_neither_jax_nor_repro():
    for path in sorted(EXAMPLES.glob("torch_*.py")):
        text = path.read_text()
        for bad in ("import jax", "from jax", "import repro.",
                    "from repro.", "from repro import"):
            assert bad not in text, f"{path.name}: {bad}"


def test_torch_online_flow_delivers_every_position_once():
    """The example's flow with a hook on every delivered batch: across the
    storage degradation, the searches' trials and any hot swap, batch k is
    the host batch of the sampler's k-th position, byte for byte (40
    batches over epochs of 16)."""
    sys.path.insert(0, str(EXAMPLES))
    try:
        ex = importlib.import_module("torch_online_tuning")
    finally:
        sys.path.remove(str(EXAMPLES))
    from repro_torch.data import DataLoader

    got = {}
    summary = ex.run(device="cpu", steps=40, drift_at=10, items=256,
                     verbose=False, on_batch=lambda k, b: got.__setitem__(
                         k, {f: v.numpy().copy() for f, v in b.items()}))
    assert summary["steps"] == 40 and len(got) == 40
    assert summary["swaps"] <= summary["retunes"]     # a swap follows a win
    ds, storage = ex.make_dataset(256)
    raw = ds.with_storage(storage.inner)
    probe = DataLoader(raw, ex.BATCH, seed=0, device="cpu")
    per_epoch = probe.sampler.batches_per_epoch(0)
    bad = [k for k, batch in got.items() if not same_bytes(
        batch, raw.get_batch(probe.sampler.local_indices(
            *divmod(k, per_epoch))))]
    assert not bad, bad
