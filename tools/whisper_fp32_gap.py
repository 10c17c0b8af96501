#!/usr/bin/env python3
"""How far fp32 ``encdec_decode_step`` and teacher-forced ``decode_forward``
drift apart in ``whisper-tiny`` at full width, in the JAX package and in
the port: the reference's own fp32 error, which phase 25 of
``chip_smoke.py`` holds the card to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/whisper_fp32_gap.py [--layers 4 2]

Runs on the CPU. The config is the full one (d_model 384, 6 heads of 64,
vocab 51865) with ``--layers`` encoder and decoder layers each, in fp32;
weights are JAX's init (``PRNGKey(0)``) converted to the port. Phase 25's
shape: 4 rows of 1500 seeded frames and 68 decoder tokens (4 prompt + 64).
The stacked init takes the layer count as the fan-in, so the attention
weights have sd 1 / sqrt(layers) and the attention logits' spread is
~100: the softmax is one-hot, and where two keys are within rounding of
each other, two orders of the same sums pick different ones. For each
depth it prints, for each package's decode loop against its
``decode_forward`` and for the port's ``decode_forward`` against JAX's
(two fp32 implementations of one function, as the card and the CPU
are), and for JAX's ``decode_forward`` on frames moved by about one ulp
against itself (the reference's own sensitivity), the largest and the
median position's max |diff| relative to the logits' RMS, the positions
above 1e-2 of the RMS, and the share of equal argmaxes.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import encdec as jed
from repro.models.module import init_params as jax_init_params
from repro_torch import configs
from repro_torch.models import convert, encdec

B, S_ENC, PROMPT, NEW = 4, 1500, 4, 64


def _cfg(registry, layers: int):
    cfg = registry.get_config("whisper-tiny").replace(dtype="float32",
                                                      num_layers=layers)
    return cfg.replace(encdec=dataclasses.replace(cfg.encdec, enc_layers=layers))


def _port(p, cfg, frames, seq):
    n = seq.shape[1]
    mem = encdec.encode(p, torch.from_numpy(frames), cfg)
    full, (_, (mk, mv)) = encdec.decode_forward(p, torch.from_numpy(seq), mem,
                                                cfg, return_cache=True)
    cache = encdec.encdec_init_cache(cfg, B, n, S_ENC, device="cpu")
    cache["mk"].copy_(mk)
    cache["mv"].copy_(mv)
    outs = []
    for t in range(n):
        lg, cache = encdec.encdec_decode_step(p, cache, torch.from_numpy(seq[:, t:t + 1]),
                                              t, cfg)
        outs.append(lg[:, 0])
    return torch.stack(outs, 1).numpy(), full.numpy()


def _jax(jp, jcfg, frames, seq):
    n = seq.shape[1]
    mem = jed.encode(jp, jnp.asarray(frames), jcfg)
    full, (_, (mk, mv)) = jed.decode_forward(jp, jnp.asarray(seq), mem, jcfg,
                                            return_cache=True)
    cache = {**jed.encdec_init_cache(jcfg, B, n, S_ENC), "mk": mk, "mv": mv}
    step = jax.jit(lambda c, t, pos: jed.encdec_decode_step(jp, c, t, pos, jcfg))
    outs = []
    for t in range(n):
        lg, cache = step(cache, jnp.asarray(seq[:, t:t + 1]), jnp.int32(t))
        outs.append(lg[:, 0])
    return np.asarray(jnp.stack(outs, 1)), np.asarray(full)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 2])
    args = ap.parse_args()
    rng = np.random.default_rng(10)
    frames = rng.standard_normal((B, S_ENC, 384)).astype(np.float32)
    seq = rng.integers(0, 51865, (B, PROMPT + NEW)).astype(np.int32)
    for layers in args.layers:
        jcfg, cfg = _cfg(jconfigs, layers), _cfg(configs, layers)
        jp = jax_init_params(jed.encdec_param_spec(jcfg), jax.random.PRNGKey(0))
        p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")
        runs = {"jax": _jax(jp, jcfg, frames, seq), "port": _port(p, cfg, frames, seq)}
        pairs = [(f"{name}: decode loop against decode_forward", dec, full)
                 for name, (dec, full) in runs.items()]
        pairs.append(("the port's decode_forward against JAX's",
                      runs["port"][1], runs["jax"][1]))
        nudged = _jax(jp, jcfg, frames * np.float32(1 + 1e-7), seq)[1]
        pairs.append(("JAX's decode_forward on the frames x (1 + 1e-7) against "
                      "JAX's", nudged, runs["jax"][1]))
        for what, got, ref in pairs:
            rms = float(np.sqrt(np.mean(ref ** 2)))
            per_pos = np.abs(got - ref).max(-1) / rms
            print(f"{layers} + {layers} layers, {what} over {seq.shape[1]} "
                  f"positions x {B} rows: max |diff| {per_pos.max():.4g} of the "
                  f"logits' RMS {rms:.4g}, the median position's "
                  f"{np.median(per_pos):.4g}; {int((per_pos > 1e-2).sum())} of "
                  f"{per_pos.size} positions above 1e-2; argmax equal at "
                  f"{100 * np.mean(got.argmax(-1) == ref.argmax(-1)):.2f}%",
                  flush=True)


if __name__ == "__main__":
    main()
