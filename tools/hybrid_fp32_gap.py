#!/usr/bin/env python3
"""How far fp32 decode and forward drift apart in ``recurrentgemma-9b`` at
one (rec, rec, attn) group, in the JAX package and in the port, by width.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/hybrid_fp32_gap.py [--widths 256 512 1024 2048] [--layers 4]

Runs on the CPU. The config is the full one (16 heads of 256, one KV head,
window 2048) with d_model = lru_width = W, d_ff = 3 W, a vocab of 1000 and
``--layers`` layers; weights are JAX's init (``PRNGKey(0)``) converted to
the port. The stacked init takes the leading axis as the fan-in, so at
one group the group's weights have sd 1, and the RG-LRU gates'
pre-activations grow with W: their rounding moves the saturated gates, and
any two fp32 orders of the same sums drift apart. For each W it prints the
max |diff| of the logits of a 16-step decode loop against ``forward`` (JAX
and the port), of the port's ``forward`` against JAX's, and the logits'
RMS; "allclose" is JAX's own test tolerance, rtol 2e-3 and atol 2e-4.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtr
from repro.models.module import init_params as jax_init_params
from repro_torch import configs
from repro_torch.models import convert
from repro_torch.models import transformer as tr


def _narrow(cfg, width: int, layers: int):
    return cfg.replace(d_model=width, d_ff=3 * width, vocab_size=1000,
                       num_layers=layers, dtype="float32",
                       hybrid=dataclasses.replace(cfg.hybrid, lru_width=width))


def gaps(width: int, layers: int, steps: int = 16) -> dict:
    jcfg = _narrow(jconfigs.get_config("recurrentgemma-9b"), width, layers)
    cfg = _narrow(configs.get_config("recurrentgemma-9b"), width, layers)
    jp = jax_init_params(jtr.param_spec(jcfg), jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    toks = np.random.default_rng(8).integers(0, 1000, (2, steps)).astype(np.int32)
    jfull = np.asarray(jtr.forward(jp, jnp.asarray(toks), jcfg)[0])
    jc, jdec = jtr.init_cache(jcfg, 2, steps), []
    for t in range(steps):
        lg, jc = jtr.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t), jcfg)
        jdec.append(np.asarray(lg[:, 0]))
    jdec = np.stack(jdec, 1)
    with torch.inference_mode():
        full = tr.forward(p, torch.from_numpy(toks), cfg)[0].numpy()
        tc, dec = tr.init_cache(cfg, 2, steps, device="cpu"), []
        for t in range(steps):
            lg, tc = tr.decode_step(p, tc, torch.from_numpy(toks[:, t:t + 1]), t, cfg)
            dec.append(lg[:, 0].numpy())
    dec = np.stack(dec, 1)
    return {"width": width, "layers": layers,
            "rms": float(np.sqrt(np.mean(jfull ** 2))),
            "jax_decode_vs_forward": float(np.abs(jdec - jfull).max()),
            "jax_allclose": bool(np.allclose(jdec, jfull, rtol=2e-3, atol=2e-4)),
            "port_decode_vs_forward": float(np.abs(dec - full).max()),
            "port_allclose": bool(np.allclose(dec, full, rtol=2e-3, atol=2e-4)),
            "port_forward_vs_jax": float(np.abs(full - jfull).max())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", type=int, nargs="+", default=[256, 512, 1024, 2048])
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args(argv)
    for width in args.widths:
        g = gaps(width, args.layers)
        print(f"W {width:5d}, {g['layers']} layers: logits RMS {g['rms']:.4g}; "
              f"decode vs forward max |diff| JAX {g['jax_decode_vs_forward']:.3g} "
              f"(allclose {g['jax_allclose']}), port "
              f"{g['port_decode_vs_forward']:.3g} (allclose {g['port_allclose']}); "
              f"port forward vs JAX forward {g['port_forward_vs_jax']:.3g}",
              flush=True)


if __name__ == "__main__":
    main()
