"""End-to-end driver: train a ViG image classifier with dynamic graph
construction in every block, on the synthetic class-conditional image
stream, with checkpoint/resume (the port's counterpart of
``examples/train_vig.py``; the same flags, plus ``--device``).

The default config is CPU-sized; ``--full`` trains the real ViG-Ti (224^2,
D = 192, 12 blocks) for ``--steps`` steps.

    PYTHONPATH=src python -m repro_torch.launch.train_vig --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train_vig --full

``--digc-impl`` takes any registered tier. The ``cuda`` tier's MRConv
kernel has no backward, so it fails at the first step (ROADMAP queue 3,
item 20), as JAX's ``pallas`` does; ``blocked`` is the default. Returns
``{"losses", "accs", "params", "cfg"}``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import available_impls, get_builder
from repro_torch.data.pipeline import DataConfig, image_pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.train import to_device
from repro_torch.models import convert, module, vig
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--full", action="store_true", help="real ViG-Ti config")
    ap.add_argument("--digc-impl", default="blocked",
                    choices=list(available_impls()))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if get_builder(args.digc_impl).distributed:
        ap.error(f"--digc-impl {args.digc_impl} needs a device mesh; "
                 "this single-host driver cannot drive it")
    dev = resolve_device(args.device)

    if args.full:
        cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(
            num_classes=args.num_classes, digc_impl=args.digc_impl
        )
        args.image_size = cfg.image_size
    else:
        cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(
            image_size=args.image_size, embed_dims=(48,), depths=(4,), k=5,
            num_classes=args.num_classes, digc_impl=args.digc_impl,
        )

    params = convert.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in module.leaves(params).values())
    print(f"ViG ({'full' if args.full else 'reduced'}): {n_params/1e6:.1f}M params, "
          f"grid {cfg.base_grid}x{cfg.base_grid}, digc={args.digc_impl}")

    oc = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                   total_steps=args.steps, weight_decay=0.01)
    step_fn = make_train_step(cfg, oc, loss_fn=vig.vig_loss_fn,
                              param_dtype=torch.float32)
    opt = init_train_state(params)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        restored, start = ckpt.restore(args.ckpt_dir, {"p": params, "o": opt})
        params, opt = restored["p"], restored["o"]
        print(f"resumed from step {start}")

    dc = DataConfig(seq_len=1, global_batch=args.batch, vocab_size=1, seed=0)
    pipe = image_pipeline(dc, args.image_size, args.num_classes, start_step=start)
    losses, accs = [], []
    try:
        for step, raw in pipe:
            if step >= args.steps:
                break
            batch = to_device(raw, dev)
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
            with torch.no_grad():
                logits = vig.vig_forward(params, batch["images"], cfg)
            accs.append(float((logits.argmax(-1) == batch["labels"]).float().mean()))
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:4d} loss {losses[-1]:.4f} acc {accs[-1]:.2f}")
            if args.ckpt_dir and (step + 1) % 50 == 0:
                ckpt.save(args.ckpt_dir, step + 1, {"p": params, "o": opt})
    finally:
        pipe.close()
    k = max(len(losses) // 5, 1)
    print(f"loss {np.mean(losses[:k]):.3f} -> {np.mean(losses[-k:]):.3f}; "
          f"acc {np.mean(accs[:k]):.2f} -> {np.mean(accs[-k:]):.2f}")
    return {"losses": losses, "accs": accs, "params": params, "cfg": cfg}


if __name__ == "__main__":
    main()
