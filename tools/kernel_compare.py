"""Time a kernel family of this checkout against variants of its source and
against another checkout, on one card.

    python3 tools/kernel_compare.py --kernel flash|ssd|ssd_bwd [--parent DIR]
        [--variant LABEL:NAME=VALUE[,NAME=VALUE...]]... [--order LABELS]
        [--cases NAME,...] [--bands W,...]

Each label runs in a process of its own, in the order given (by default
``parent,change,<variants>,change,parent``, so a drift of the card shows
as two readings of one label that differ): ``change`` is this checkout's
library; ``parent`` the checkout at DIR (its own ``src``, built into its
own ``build/``); a variant this checkout's ``csrc`` copied to
``build/variants/<label>`` with each ``constexpr int NAME = ...;`` (or
``long long``) of the family's source set to VALUE (``--kernel flash
--variant wg2:FWD_WG=2`` builds the flash forward with two consumer
warpgroups; ``--kernel ssd --variant h1:WQ_HEADS=1`` the SSD chunk scan
with one head a block).  The libraries are built first, one nvcc each,
all at once.

A process prints one JSON line a case, at the shapes of ``chip_smoke.py``'s
rows, inputs from a fixed seed, bf16, device times by ``torch.profiler``
over 20 calls, L2-warm:

* ``flash``: the forward kernels (``csrc/flash_attention.cu``): ``ms``,
  one call's device time; ``host_us`` for the rows serving calls
  (``slice``, the decode rows), one ``flash_attention`` call's host time
  (200 calls without a sync, the least of five such runs).
* ``ssd``: the SSD scan (``csrc/ssd_scan.cu``) through the entry a row of
  ``chip_smoke.py`` calls, ``ops.ssd`` or, for the rows with a state,
  ``ops.ssd_prefill`` (which pads to the chunk): ``ms``; ``variant``, the
  kernels that served it; ``stages_ms``, each kernel of that variant
  alone through its C entry on buffers made once (``stages`` rows).
* ``ssd_bwd``: the SSD scan's backward (``csrc/ssd_scan_bwd.cu``, which
  walks the entering states again itself) through
  ``ssd_scan.backward_kernel`` at ``chip_smoke.py``'s bf16 backward rows
  at the models' shapes (its ``SSD_BWD_CASES``): ``ms``; ``variant``, the
  kernels that served it (``backward_launches_by_variant``);
  ``stages_ms``, each kernel's device time in one call; ``err_of_max``,
  the largest distance of a gradient from the fp32 autograd recompute
  over its largest entry.  A checkout without backward kernels (``parent``
  before them) times its backward, the plain recompute
  ``ssd_scan_backward``, and says so (``variant`` "plain").  ``--bands
  4,2,1`` also times a checkout's wgmma kernels with the band of heads
  forced to each width (``ssd_scan.backward_band``, capped at the group's
  heads): ``band_ms``, and ``band_stages_ms`` each kernel's time.

``atol_needed_of_max`` is the least absolute tolerance the output needs
against the plain twin in fp32 at rtol 2^-8 (flash) or 2e-2 (ssd, as
``chip_smoke.TOL_SSD``), over the largest reference entry.  The card's
name and power limit are printed first, and the last line is {case:
{label: [ms, ...]}}.  Needs the card; it imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (B, S, T, H, K, D, causal, window, q_offset, form): form "fwd"
# is the forward without lse, "lse" the forward that _FlashAttention runs,
# "partial" flash_attention_partial
FLASH_CASES = {
    "slice": (8, 512, 512, 14, 2, 64, True, 0, 0, "fwd"),
    "granite": (8, 512, 512, 24, 8, 64, True, 0, 0, "fwd"),
    "hymba_global": (8, 640, 640, 25, 5, 64, True, 0, 0, "fwd"),
    "phi3v": (8, 1088, 1088, 32, 32, 96, True, 0, 0, "fwd"),
    "whisper_enc": (8, 1500, 1500, 20, 20, 64, False, 0, 0, "fwd"),
    "whisper_cross": (8, 224, 1500, 20, 20, 64, False, 0, 0, "fwd"),
    "whisper_cross_decode": (8, 1, 1500, 20, 20, 64, False, 0, 0, "fwd"),
    "whisper_self": (8, 224, 224, 20, 20, 64, True, 0, 0, "fwd"),
    "tp_whisper_enc_rank": (2, 1500, 1500, 10, 10, 64, False, 0, 0, "fwd"),
    "tp_whisper_cross_decode_rank": (2, 1, 750, 10, 10, 64, False, 0, 0,
                                     "partial"),
    "d128": (2, 256, 256, 16, 8, 128, True, 0, 0, "fwd"),
    "mixtral_window": (2, 4608, 4608, 48, 8, 128, True, 4096, 0, "fwd"),
    "train": (4, 2048, 2048, 14, 2, 64, True, 0, 0, "lse"),
}
FLASH_HOST_CASES = ("slice", "whisper_cross_decode",
                    "tp_whisper_cross_decode_rank")
# name -> (b, s, h, p, g, n, chunk, strided, state): chip_smoke.py's SSD
# rows at the model's shapes (strided: x, B and C views of one conv output;
# state: through ops.ssd_prefill, which writes the final state too)
SSD_CASES = {
    "slice": (4, 2048, 48, 64, 1, 128, 256, True, False),
    "fleet6": (6, 2048, 48, 64, 1, 128, 256, True, False),
    "dp_mb": (2, 2048, 48, 64, 1, 128, 256, True, False),
    "padded300": (2, 300, 48, 64, 1, 128, 256, False, False),
    "serve_prefill": (8, 512, 48, 64, 1, 128, 256, True, True),
    "serve_prefill300": (4, 300, 48, 64, 1, 128, 256, True, True),
    "hymba_prefill": (8, 640, 50, 64, 1, 16, 256, True, True),
    "tp_hybrid_rank": (2, 640, 25, 64, 1, 16, 256, True, False),
    "tp_ssm_rank": (2, 512, 24, 64, 1, 128, 256, True, False),
}
# the rows whose kernels are also timed alone
SSD_STAGE_CASES = ("slice", "hymba_prefill")


def smoke_bwd_cases() -> dict:
    """name -> (b, s, h, p, g, n, chunk, strided): the rows of
    ``chip_smoke.SSD_BWD_CASES`` at the models' shapes (bf16, x, B and C
    views of one conv output; tp_hybrid_rank's 640 positions a ragged
    end), read from that script so the two lists cannot drift apart."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return {name: (*shape, strided)
            for name, (shape, strided, dtype) in cs.SSD_BWD_CASES.items()
            if dtype == "bfloat16" and strided}


SSD_BWD_CASES = smoke_bwd_cases()
SOURCES = {"flash": "flash_attention", "ssd": "ssd_scan",
           "ssd_bwd": "ssd_scan_bwd"}
CASES = {"flash": FLASH_CASES, "ssd": SSD_CASES, "ssd_bwd": SSD_BWD_CASES}


def variant_dir(label: str) -> Path:
    return ROOT / "build" / "variants" / label


def make_variant(label: str, source: str, sets: dict) -> Path:
    """This checkout's csrc copied with the constants of ``source`` set."""
    out = variant_dir(label)
    if out.exists():
        shutil.rmtree(out)
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    shutil.copytree(csrc, out / "csrc")
    path = out / "csrc" / f"{source}.cu"
    text = path.read_text()
    for name, value in sets.items():
        text, n = re.subn(rf"constexpr (int|long long) {name} = [^;]+;",
                          rf"constexpr \1 {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"{name}: {n} definitions in {source}.cu")
    path.write_text(text)
    return out


def setup(label: str, parent):
    """Import the package of `label` and point its build at its sources."""
    src = Path(parent) / "src" if label == "parent" else ROOT / "src"
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    if label not in ("change", "parent"):
        _build.CSRC = variant_dir(label) / "csrc"
        _build.BUILD_DIR = variant_dir(label) / "kernels"
    return _build


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one call: the profiler's summed kernel time over
    ``iters`` calls (a window that saw fewer kernels is retried), else
    CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        busy = sum(e.self_device_time_total for e in avgs)
        if busy > 0 and sum(e.count for e in avgs
                            if e.self_device_time_total > 0) >= iters:
            return busy / 1e3 / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_worker(label: str, torch, cases) -> None:
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in cases:
        B, S, T, H, K, D, causal, window, q_offset, form = FLASH_CASES[name]
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((B, T, K, D), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        if form == "partial":
            def call():
                return fa.flash_attention_partial(q, k, v, causal=False)[0]
        else:
            lse = (torch.empty((B, H, S), dtype=torch.float32, device="cuda")
                   if form == "lse" else None)

            def call():
                return fa._forward_kernel(q, k, v, causal, window, q_offset,
                                          None, lse)
        out = call().float()
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        ref_max = float(ref.abs().max())
        need = float(((out - ref).abs() - 2 ** -8 * ref.abs()).max())
        del out, ref
        row = dict(label=label, case=name, ms=device_ms(torch, call),
                   atol_needed_of_max=max(0.0, need) / ref_max)
        if name in FLASH_HOST_CASES:
            for _ in range(10):
                call()
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    if form == "partial":
                        fa.flash_attention_partial(q, k, v, causal=False)
                    else:
                        fa.flash_attention(q, k, v, **kw)
                runs.append((time.perf_counter() - t0) / 200 * 1e6)
            row["host_us"], row["host_us_runs"] = min(runs), runs
            torch.cuda.synchronize()
        print(json.dumps(row), flush=True)


def ssd_inputs(torch, gen, b, s, h, p, g, n, strided):
    """chip_smoke.ssd_inputs in bf16: dt = softplus(N(0,1)), A =
    -exp(N(0,1)/2), x, B and C N(0,1), strided as slices of one tensor."""
    F = torch.nn.functional
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device="cuda"))
    if strided:
        u = torch.randn((b, s, h * p + 2 * g * n), generator=gen,
                        device="cuda").bfloat16()
        xs, Bm, Cm = torch.split(u, [h * p, g * n, g * n], dim=-1)
        return (xs.reshape(b, s, h, p), dt, A, Bm.reshape(b, s, g, n),
                Cm.reshape(b, s, g, n))
    x, B, C = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
               for shape in ((b, s, h, p), (b, s, g, n), (b, s, g, n)))
    return x, dt, A, B, C


def ssd_stage_ms(torch, ss, ref, x, dt, A, B, C, chunk) -> dict:
    """Each kernel of the variant serving these inputs alone, through its C
    entry, on buffers made once (the parent's flat STAGES: the mma
    kernels)."""
    flat = not isinstance(next(iter(ss.STAGES.values())), dict)
    which = "mma" if flat else ss._variant_of(x, B, C, chunk)
    entries = ss.STAGES if flat else ss.STAGES[which]
    A = A.float().contiguous()
    y = torch.empty_like(x)
    cum, states = ref.ssd_chunk_state(x, dt, A, B, chunk=chunk)
    entering, _ = ref.ssd_state_passing(states, cum)
    cum = cum.contiguous()
    bufs = {"chunk_state": (torch.empty_like(cum), torch.empty_like(states)),
            "state_passing": (cum, states.contiguous().clone()),
            "chunk_scan": (cum, entering.contiguous()),
            "state": (torch.empty_like(cum),
                      ref.ssd_state_split(entering).contiguous()
                      if hasattr(ref, "ssd_state_split") else None)}
    if which == "wgmma":
        bufs["chunk_scan"] = (cum, ref.ssd_state_split(entering).contiguous())
    out = {}
    for stage, entry in entries.items():
        c_, s_ = bufs[stage]
        out[stage] = device_ms(torch, lambda: ss._call(
            entry, x, dt, A, B, C, y, c_, s_, chunk))
    return out


def ssd_worker(label: str, torch, cases) -> None:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in cases:
        b, s, h, p, g, n, chunk, strided, state = SSD_CASES[name]
        x, dt, A, B, C = ssd_inputs(torch, gen, b, s, h, p, g, n, strided)
        fn = ops.ssd_prefill if state else ops.ssd

        def call():
            out = fn(x, dt, A, B, C, chunk=chunk)
            return out[0] if state else out
        before = dict(getattr(ss.ssd_scan, "launches_by_variant", {}))
        out = call().float()
        after = getattr(ss.ssd_scan, "launches_by_variant", {})
        used = [k for k in after if after[k] != before.get(k)]
        xp, dtp, Bp, Cp, cp = ops._pad_to_chunk(x, dt, B, C, chunk)
        yr = ref.ssd_chunked(xp, dtp, A, Bp, Cp, chunk=cp)[0][:, :s].float()
        need = float(((out - yr).abs() - 2e-2 * yr.abs()).max())
        row = dict(label=label, case=name,
                   variant=used[0] if len(used) == 1 else "mma",
                   ms=device_ms(torch, call),
                   atol_needed_of_max=max(0.0, need)
                   / float(yr.abs().max()))
        del out, yr
        if name in SSD_STAGE_CASES:
            row["stages_ms"] = ssd_stage_ms(torch, ss, ref, xp, dtp, A, Bp,
                                            Cp, cp)
        print(json.dumps(row), flush=True)


def ssd_bwd_worker(label: str, torch, cases, bands=()) -> None:
    from repro_torch.kernels import ssd_scan as ss
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = hasattr(ss, "backward_kernel")
    for name in cases:
        b, s, h, p, g, n, chunk, strided = SSD_BWD_CASES[name]
        x, dt, A, B, C = ssd_inputs(torch, gen, b, s, h, p, g, n, strided)
        dy = torch.randn((b, s, h, p), generator=gen,
                         device="cuda").bfloat16()

        def call():
            if kernels:
                return ss.backward_kernel(x, dt, A, B, C, dy, chunk=chunk)
            return ss.ssd_scan_backward(x, dt, A, B, C, dy, chunk=chunk)

        before = dict(getattr(ss.ssd_scan, "backward_launches_by_variant",
                              {}))
        got = call()
        after = getattr(ss.ssd_scan, "backward_launches_by_variant", {})
        used = [k for k in after if after[k] != before.get(k)]
        oracle = ss.ssd_scan_backward(x.float(), dt, A, B.float(),
                                      C.float(), dy.float(), chunk=chunk)
        err = max(float((a.float() - r).abs().max() / r.abs().max())
                  for a, r in zip(got, oracle))
        del got, oracle
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        stages = {e.key[:60]: e.self_device_time_total / 1e3
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0}
        row = dict(label=label, case=name,
                   variant=used[0] if kernels and len(used) == 1 else "plain",
                   ms=device_ms(torch, call), err_of_max=err)
        if kernels:
            row["stages_ms"] = stages
        if bands and hasattr(ss, "backward_band") and row["variant"] == "wgmma":
            chosen = ss.backward_band
            row["band"] = chosen(b, s, h, g, chunk, "wgmma")
            row["band_ms"], row["band_stages_ms"] = {}, {}
            for w in bands:
                ss.backward_band = (lambda b_, s_, h_, g_, c_, which, w=w:
                                    min(w, h_ // g_) if which == "wgmma"
                                    else 1)
                try:
                    row["band_ms"][w] = device_ms(torch, call)
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        call()
                        torch.cuda.synchronize()
                    row["band_stages_ms"][w] = {
                        e.key[:60]: e.self_device_time_total / 1e3
                        for e in prof.key_averages()
                        if e.self_device_time_total > 0}
                finally:
                    ss.backward_band = chosen
        print(json.dumps(row), flush=True)


def worker(kernel: str, label: str, parent, cases, bands=()) -> None:
    setup(label, parent)
    import torch
    device_ms(torch, lambda: torch.ones(1, device="cuda").add_(1))
    if kernel == "ssd_bwd":
        ssd_bwd_worker(label, torch, cases, bands)
        return
    {"flash": flash_worker, "ssd": ssd_worker}[kernel](label, torch, cases)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="flash")
    ap.add_argument("--parent")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--order")
    ap.add_argument("--cases")
    ap.add_argument("--bands")
    ap.add_argument("--worker")
    ap.add_argument("--build")
    args = ap.parse_args()
    all_cases = CASES[args.kernel]
    cases = args.cases.split(",") if args.cases else list(all_cases)
    unknown = [c for c in cases if c not in all_cases]
    if unknown:
        raise SystemExit(f"no {args.kernel} case {unknown}")
    bands = [int(w) for w in args.bands.split(",")] if args.bands else []
    if args.worker:
        worker(args.kernel, args.worker, args.parent, cases, bands)
        return 0
    if args.build:
        _build = setup(args.build, args.parent)
        name = SOURCES[args.kernel]
        # a parent from before the backward kernels has no source to build
        if args.build != "parent" or (_build.CSRC / f"{name}.cu").exists():
            _build.build(name)
        return 0
    variants = {}
    for v in args.variant:
        label, _, spec = v.partition(":")
        variants[label] = dict(s.split("=", 1) for s in spec.split(","))
    labels = (["parent"] if args.parent else []) + ["change"] + list(variants)
    order = (args.order.split(",") if args.order else
             labels + ["change"] + (["parent"] if args.parent else []))
    for label, sets in variants.items():
        make_variant(label, SOURCES[args.kernel], sets)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    me = [sys.executable, __file__, "--kernel", args.kernel,
          "--cases", ",".join(cases)] + (["--parent", args.parent]
                                         if args.parent else []) + (
        ["--bands", args.bands] if args.bands else [])
    t0 = time.perf_counter()
    builds = [subprocess.Popen(me + ["--build", label]) for label in labels]
    if any(p.wait() for p in builds):
        return 1
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    table = {}
    for label in order:
        run = subprocess.run(me + ["--worker", label], capture_output=True,
                             text=True)
        sys.stdout.write(run.stdout)
        if run.returncode:
            sys.stderr.write(run.stderr)
            return 1
        for line in run.stdout.splitlines():
            row = json.loads(line)
            table.setdefault(row["case"], {}).setdefault(label, []).append(
                round(row["ms"], 4))
    print(json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
