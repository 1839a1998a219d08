"""Serving launcher: ``python -m repro_torch.launch.serve --arch qwen2-0.5b``

Builds the model with weights drawn from a seeded generator, spins up the
batching frontend and runs a synthetic request workload through prefill
and decode (greedy or sampled), printing a JSON summary.  Runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is given; without
``--reduced`` it serves the full-width config.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import DecoderLM, build_model
    from repro_torch.models.module import init_params
    from repro_torch.serve.engine import BatchingFrontend, ServeEngine
    from repro_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(DecoderLM.param_specs(cfg), gen)
    model = build_model(cfg, params, device=device)
    del params
    engine = ServeEngine(model, max_batch=args.max_batch,
                         max_len=args.prompt_len + args.max_new + 8,
                         temperature=args.temperature, device=device)
    frontend = BatchingFrontend(engine)

    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, (args.prompt_len,))
        reqs.append(frontend.submit(prompt.astype(np.int32), args.max_new))
    outs = [r.result.get(timeout=600) for r in reqs]
    frontend.shutdown()
    print(json.dumps({
        "arch": cfg.name,
        "device": str(device),
        "requests": len(outs),
        "batches_served": frontend.batches_served,
        "tokens_generated": int(sum(len(o) for o in outs)),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
