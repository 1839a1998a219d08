"""Serve a small model with batched requests on the PyTorch port: prefill
plus decode over the engine's cache (K/V for a dense model, the conv tail
and SSD state for mamba2) through the ServeEngine, then concurrent clients
through the BatchingFrontend (requests arriving within a window are
batched together).  Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_serve_batched.py
    PYTHONPATH=src python examples/torch_serve_batched.py --arch mamba2-780m
        (the reduced same-family config of a ported arch)
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""
import argparse
import os
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import DecoderLM, build_model
from repro_torch.models.module import init_params
from repro_torch.serve.engine import BatchingFrontend, ServeEngine
from repro_torch.utils.device import resolve_device

PROMPT_LEN = 16


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--clients", type=int, default=6)
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    params = init_params(DecoderLM.param_specs(cfg),
                         torch.Generator(device=device).manual_seed(0))
    model = build_model(cfg, params, device=device)
    del params
    print(f"serving {cfg.name} on {device}: {cfg.num_layers}L "
          f"d={cfg.d_model} vocab={cfg.vocab_size}")

    engine = ServeEngine(model, max_batch=8,
                         max_len=PROMPT_LEN + args.new_tokens,
                         temperature=0.8, device=device)

    # --- direct batched generate ------------------------------------------
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (4, PROMPT_LEN)).astype(np.int32)
    r = engine.generate(prompts, args.new_tokens)
    print(f"\nbatched generate: {r.tokens.shape[0]} seqs x "
          f"{r.tokens.shape[1]} new tokens | prefill {r.prefill_s*1e3:.0f} ms"
          f" | decode {r.decode_s*1e3:.0f} ms "
          f"({r.tokens_per_second:.0f} tok/s)")
    print("first sequence:", r.tokens[0, :12], "...")

    # --- concurrent clients through the batching frontend -------------------
    fe = BatchingFrontend(engine, max_wait_s=0.05)
    results = {}
    client_prompts = rng.integers(0, cfg.vocab_size,
                                  (args.clients, PROMPT_LEN))

    def client(i):
        req = fe.submit(client_prompts[i].astype(np.int32), args.new_tokens)
        results[i] = req.result.get(timeout=300)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fe.shutdown()
    sizes = {i: (v.shape if v is not None else None)
             for i, v in sorted(results.items())}
    print(f"\nfrontend served {len(results)} concurrent requests in "
          f"{fe.batches_served} batches: {sizes}")
    assert len(results) == args.clients
    assert all(v is not None for v in results.values())
    print("OK")


if __name__ == "__main__":
    main()
