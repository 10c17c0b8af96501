#!/usr/bin/env python3
"""How far each package's fp32 loss gradients are from an fp64 evaluation,
per SMOKE arch: the floor that a grad parity test between the two fp32
implementations can be held to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/grad_fp64_gap.py [--archs whisper-tiny olmo-1b ...]

Runs on the CPU. Weights are JAX's init (``PRNGKey(0)``) converted to the
port; the batch is ``tests/test_torch_train.py``'s (B = 2, S = 16). The
fp64 evaluation is the port's loss in float64: this process makes the
config's compute dtype float64 and ``Tensor.float`` return float64 (the
norms, softmaxes and the loss cast through it), so it runs in a process
of its own, after both fp32 gradients are taken. For each arch it prints
the loss three ways and, over the leaves, the largest RMS error relative
to the leaf's RMS of JAX's fp32 grads and of the port's against the fp64
ones, and of the port's against JAX's; leaves whose fp64 grad is zero up
to rounding (a key bias) are left out of the ratios. The MoE archs are
not run: their dispatch scatters gates into an fp32 buffer, which an fp64
evaluation cannot fill.
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.launch.api import get_api as jax_get_api
from repro.models.module import init_params as jax_init_params
from repro_torch import configs
from repro_torch.launch.api import get_api
from repro_torch.models import convert, module
from repro_torch.models.config import ModelConfig
from repro_torch.train.trainer import value_and_grad

B, S = 2, 16


def _batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "mask": np.ones((B, S), np.float32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(pos, (3, B, S)))
    return batch


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.asarray(a, np.float64) ** 2)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+", default=[
        a for a in configs.ARCH_IDS if configs.get_smoke(a).moe is None])
    args = ap.parse_args()
    fp32 = {}
    for arch in args.archs:
        jcfg = jconfigs.get_smoke(arch).replace(dtype="float32")
        cfg = configs.get_smoke(arch).replace(dtype="float32")
        ja, a = jax_get_api(jcfg), get_api(cfg)
        jp = jax_init_params(ja.param_spec(), jax.random.PRNGKey(0))
        p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")
        batch = _batch(cfg)
        (jl, _), jg = jax.value_and_grad(
            lambda q: ja.loss_fn(q, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jcfg), has_aux=True)(jp)
        loss, _, g = value_and_grad(a.loss_fn, p, {k: torch.from_numpy(v) for k, v
                                                   in batch.items()}, cfg)
        fp32[arch] = (cfg, a, p, batch, float(jl), float(loss),
                      module.leaves(jax.tree.map(np.asarray, jg)),
                      {k: t.numpy() for k, t in module.leaves(g).items()})
    ModelConfig.compute_dtype = property(lambda self: torch.float64)
    torch.Tensor.float = lambda self, *a, **k: self.double()
    for arch, (cfg, a, p, batch, jl, loss, jg, g) in fp32.items():
        p64 = module.map_tree(lambda _, t: t.double(), p)
        b64 = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32
                                   else v) for k, v in batch.items()}
        l64, _, g64 = value_and_grad(a.loss_fn, p64, b64, cfg)
        ref = {k: t.numpy() for k, t in module.leaves(g64).items()}
        floor = 1e-6 * max(_rms(r) for r in ref.values())
        live = [k for k, r in ref.items() if _rms(r) > floor]
        worst = lambda x, y: max(_rms(x[k] - y[k]) / _rms(y[k]) for k in live)
        print(f"{arch}: loss jax fp32 {jl:.9g}, port fp32 {loss:.9g}, fp64 "
              f"{float(l64):.9g}; largest grad RMS error / leaf RMS: jax fp32 "
              f"vs fp64 {worst(jg, ref):.3g}, port fp32 vs fp64 "
              f"{worst(g, ref):.3g}, port vs jax {worst(g, jg):.3g} "
              f"({len(live)} of {len(ref)} leaves)", flush=True)


if __name__ == "__main__":
    main()
