"""Serve a small LM with batched requests through the slot-based
continuous-batching engine (the twin of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch olmo-1b --requests 6
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.device import resolve_device
from repro_torch.launch.api import get_api
from repro_torch.models.module import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke(args.arch)
    api = get_api(cfg)
    params = init_params(api.param_spec(),
                         generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    engine = ServeEngine(cfg, params, slots=args.slots,
                         max_len=args.prompt_len + args.new_tokens + 4, device=dev)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=args.new_tokens))
    finished = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out_tokens) for r in finished)
    for r in sorted(finished, key=lambda r: r.uid):
        print(f"req {r.uid}: prompt[:4]={r.prompt[:4].tolist()} -> "
              f"out={r.out_tokens}")
    print(f"{len(finished)} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s on {dev}, host clock, "
          f"{args.slots} slots)")
    return finished


if __name__ == "__main__":
    main()
