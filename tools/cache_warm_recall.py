#!/usr/bin/env python3
"""The legacy eager ``DigcCache``'s recall at full width, in the JAX package
and in the port: ``vig_ti_iso`` at 224^2 (12 blocks, D = 192) on the
``cluster`` tier, one forward of ``--batch`` seeded images with a fresh
cache (block 1 cold, blocks 2-12 warm-started from the block before them
in 2 Lloyd iterations) and one without a cache (every block cold, 5
iterations).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/cache_warm_recall.py [--batch 8]

Runs on the CPU. Weights are JAX's init (``PRNGKey(0)``), converted to the
port. For each package it prints each block's neighbour recall against
the exact lists on the block's own features (JAX's ``digc_reference``,
the port's ``digc_topk_plain``) and the means, with and without the cache.
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.digc import digc_reference
from repro.core.engine import DigcCache as JaxCache
from repro.models import vig as jvig
from repro.models.module import init_params as jax_init_params
from repro_torch import testing
from repro_torch.core.engine import DigcCache
from repro_torch.kernels.digc_topk import digc_topk_plain
from repro_torch.models import convert, vig


def recall(idx, exact) -> float:
    a = np.asarray(idx).reshape(-1, exact.shape[-1])
    e = np.asarray(exact).reshape(-1, exact.shape[-1])
    return float(np.mean([len(set(x) & set(y)) / len(y) for x, y in zip(a, e)]))


def recorded(module, run):
    """``run()`` with ``module.digc`` recording (h, spec, idx) per call."""
    log, real = [], module.digc

    def record(h, cond=None, *, spec, **kw):
        idx = real(h, cond, spec=spec, **kw)
        log.append((h, spec, idx))
        return idx

    module.digc = record
    try:
        run()
    finally:
        module.digc = real
    return log


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(digc_impl="cluster")
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(digc_impl="cluster")
    jp = jax_init_params(jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    images = testing.images(2800, args.batch, cfg.image_size)

    def jax_recalls(cache):
        log = recorded(jvig, lambda: jvig.vig_forward(jp, jnp.asarray(images), jcfg,
                                                      cache=cache))
        return [recall(idx, digc_reference(h, h, k=s.k, dilation=s.dilation))
                for h, s, idx in log]

    def port_recalls(cache):
        with torch.inference_mode():
            log = recorded(vig, lambda: vig.vig_forward(tp, torch.from_numpy(images),
                                                        cfg, cache=cache))
            return [recall(idx, digc_topk_plain(h, h, s.k * s.dilation)[1]
                           [..., ::s.dilation]) for h, s, idx in log]

    for name, fn, cache in (("JAX", jax_recalls, JaxCache),
                            ("port", port_recalls, DigcCache)):
        warm, cold = fn(cache()), fn(None)
        print(f"{name}: per block, with the cache {np.round(warm, 3).tolist()}")
        print(f"{name}: mean recall {np.mean(warm):.4f} with the cache, "
              f"{np.mean(cold):.4f} without")


if __name__ == "__main__":
    main()
