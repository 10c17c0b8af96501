"""Beyond the paper: DIGC as the neighbour-list engine of KNN-sparse
attention, against dense causal attention on a long sequence (the twin of
``examples/knn_attention_longctx.py``): agreement on the early rows, the
time of each, and the memory argument.

    PYTHONPATH=src python -m repro_torch.examples.knn_attention_longctx --seq 2048

Times are CUDA events around one call after a warm-up call on the card,
the host clock on the CPU; the line says which.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.knn_attention import knn_attention_mha
from repro_torch.device import resolve_device


def dense_causal(q, k, v):
    s = q.shape[0]
    logits = torch.einsum("shd,thd->hst", q, k) / np.sqrt(q.shape[-1])
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    logits = torch.where(mask[None], logits, -torch.inf)
    return torch.einsum("hst,thd->shd", torch.softmax(logits, -1), v)


def _timed(fn, dev: torch.device) -> tuple:
    """(output, ms) of one call after a warm-up call."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dh", type=int, default=32)
    ap.add_argument("--neighbors", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    s, h, dh = args.seq, args.heads, args.dh
    q, k, v = (torch.as_tensor(rng.standard_normal((s, h, dh)),
                               dtype=torch.float32, device=dev)
               for _ in range(3))

    out_d, td = _timed(lambda: dense_causal(q, k, v), dev)
    out_k, tk = _timed(lambda: knn_attention_mha(
        q, k, v, num_neighbors=args.neighbors, causal=True), dev)

    nn = args.neighbors
    early = float((out_d[:nn] - out_k[:nn]).abs().max())
    cos = float(((out_d * out_k).sum(-1)
                 / (out_d.norm(dim=-1) * out_k.norm(dim=-1) + 1e-9)).mean())
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"seq={s} heads={h} neighbors={nn} ({dev})")
    print(f"  early rows (full history covered) max err: {early:.2e}")
    print(f"  mean cosine similarity dense vs knn: {cos:.3f}")
    print(f"  dense: {td:.3f}ms ({clock}; O(S^2) scores = {s*s*h*4/1e6:.0f} MB)")
    print(f"  knn:   {tk:.3f}ms ({clock}; O(S*k) gathered = {s*nn*h*4/1e6:.1f} MB)")
    print("  decode cost per token: dense O(S) vs knn top-k over cache;")
    print("  cache memory identical, attention compute k/S =",
          f"{nn/s:.3%} of dense")
    return {"early": early, "cos": cos, "dense_ms": td, "knn_ms": tk}


if __name__ == "__main__":
    main()
