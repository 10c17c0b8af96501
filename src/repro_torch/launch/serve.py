"""Serving driver: batched requests through the slot engine (port of
``repro/launch/serve.py``; the same flags, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --requests 8 --slots 4

Weights are drawn by ``models.module.init_params`` from a seeded
``torch.Generator`` on the serving device, straight into the compute
tree's dtypes (bf16 weights, fp32 norms and router) one slice at a time,
so no fp32 tree exists beside the one the engine serves: that is what
lets one card hold ``deepseek-v2-lite-16b`` whole. Nothing is
downloaded.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.launch.api import get_api
from repro_torch.models import transformer as tr
from repro_torch.models.module import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    api = get_api(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(api.param_spec(), generator=gen, device=dev,
                         dtype_of=lambda path: tr.compute_dtype(path, cfg))
    max_len = args.max_len or (args.prompt_len + args.new_tokens + 8)
    engine = ServeEngine(cfg, params, slots=args.slots, max_len=max_len,
                         device=dev)
    del params  # the engine holds these same tensors (no copy: dtypes match)
    if dev.type == "cuda":
        print(f"peak device memory allocated after the engine is built: "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")

    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=args.new_tokens))
    t0 = time.perf_counter()
    finished = engine.run()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in finished)
    print(f"served {len(finished)} requests / {tokens} tokens in {dt:.1f}s "
          f"({tokens/dt:.1f} tok/s, {args.slots} slots)")
    return finished


if __name__ == "__main__":
    main()
