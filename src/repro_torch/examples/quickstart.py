"""Quickstart: build dynamic image graphs with DIGC through the
GraphBuilder registry (every single-device tier), batched, then run a
tiny ViG forward (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The ``cuda`` tier launches the DIGC kernel on the card (its plain PyTorch
version on the CPU). ``reference`` and ``blocked`` must agree bit for bit;
the kernel sums fp32 distances in another order, so its lists are held to
``blocked`` by the near-tie rule (``repro_torch.testing``): equal but
where two candidates' distances are within fp32 rounding.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import testing
from repro_torch.core import (
    DigcSpec,
    available_impls,
    degree_histogram,
    digc,
    edge_list,
    fpga_cycles,
)
from repro_torch.device import resolve_device
from repro_torch.models import vig
from repro_torch.models.convert import init_params

# fp32 rounding of |x|^2 - 2 x.y + |y|^2 at D = 192: relative, and
# absolute against the squared norms (chip_smoke.py's RTOL / ATOL).
RTOL, ATOL = 1e-5, 1e-4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- 1. DIGC on the paper's ViG-Tiny workload: N=M=196, D=192 -----
    b, n, d, k, dil = 2, 196, 192, 8, 2
    feats = torch.as_tensor(rng.standard_normal((b, n, d)),
                            dtype=torch.float32, device=dev)

    print(f"registered DIGC builders: {available_impls()}")
    idx_ref = digc(feats, spec=DigcSpec(impl="reference", k=k, dilation=dil))
    idx_blk, d_blk = digc(feats, spec=DigcSpec(impl="blocked", k=k, dilation=dil),
                          return_dists=True)
    idx_cu, d_cu = digc(feats, spec=DigcSpec(impl="cuda", k=k, dilation=dil),
                        return_dists=True)
    if not torch.equal(idx_ref, idx_blk):
        raise AssertionError("reference and blocked neighbour lists differ")
    scale = 2 * float(feats.square().sum(-1).max())
    testing.assert_topk_match(idx_cu.cpu().numpy(), d_cu.cpu().numpy(),
                              idx_blk.cpu().numpy(), d_blk.cpu().numpy(),
                              rtol=RTOL, atol=ATOL + RTOL * scale)
    swaps = int((idx_cu != idx_blk).sum())
    print(f"DIGC: batch={b}, {n} nodes, k={k}, dilation={dil}, {dev}")
    print("  neighbor lists agree across reference/blocked: True; "
          f"cuda: True but {swaps} near-tie swaps")
    edges = edge_list(idx_blk[0])
    deg = degree_histogram(idx_blk[0], n)
    print(f"  edges={edges.shape[1]}, in-degree mean={float(deg.float().mean()):.1f} "
          f"max={int(deg.max())}")
    print(f"  paper Table I cycle model @ this workload: {fpga_cycles(n, n, d, k)}")

    # single-image (N, D) still works: promoted to B=1 internally
    idx_one = digc(feats[0], k=k, dilation=dil, impl="blocked")
    if not torch.equal(idx_one, idx_blk[0]):
        raise AssertionError("the single-image call differs from the batch's row")

    # --- 2. tiny ViG classifier forward --------------------------------
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(
        image_size=64, embed_dims=(48,), depths=(2,), num_classes=10, k=5)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    images = torch.as_tensor(rng.standard_normal((2, 64, 64, 3)),
                             dtype=torch.float32, device=dev)
    with torch.no_grad():
        logits = vig.vig_forward(params, images, cfg)
    print(f"ViG forward: images {tuple(images.shape)} -> logits {tuple(logits.shape)}")
    preds = logits.argmax(-1).tolist()
    print(f"  predictions: {preds}")
    return {"swaps": swaps, "edges": int(edges.shape[1]), "preds": preds}


if __name__ == "__main__":
    main()
