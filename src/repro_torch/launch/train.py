"""End-to-end training driver (port of ``repro/launch/train.py``; the same
flags, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Wires together: the config registry, a seeded fp32 init drawn on the
device (or a resume from the newest committed checkpoint under
``--ckpt-dir``, which continues the straight run: the parameters restore
in bf16, as a step left them), the synthetic data pipeline with
prefetch, the train step (run eagerly), the straggler monitor and
asynchronous checkpoints. Returns the losses.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import DataConfig, lm_pipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.launch.api import get_api
from repro_torch.models.module import init_params, map_tree
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import init_train_state, make_train_step


PARAM_DTYPE = torch.bfloat16  # parameters after a step; the master is fp32


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "audio":
        raise SystemExit("use examples/train_vig.py-style drivers for enc-dec")
    dev = resolve_device(args.device)
    api = get_api(cfg)
    oc = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                   total_steps=args.steps)
    train_step = make_train_step(cfg, oc, loss_fn=api.loss_fn,
                                 accum_steps=args.accum, param_dtype=PARAM_DTYPE)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(api.param_spec(), generator=gen, device=dev)
    opt_state = init_train_state(params)
    start_step = 0

    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            # A step's parameters are bf16 (the train step's param_dtype),
            # so they restore as bf16. JAX's driver restores them into its
            # fp32 init, and its resumed first step takes fp32 grads where
            # a straight run's are bf16 (ROADMAP queue 3, item 22).
            state_like = {"params": map_tree(lambda _, t: t.to(PARAM_DTYPE), params),
                          "opt": opt_state}
            restored, start_step = ckpt.restore(args.ckpt_dir, state_like)
            params, opt_state = restored["params"], restored["opt"]
            print(f"resumed from step {start_step}")

    dc = DataConfig(seq_len=args.seq, global_batch=args.batch,
                    vocab_size=cfg.vocab_size, seed=args.seed)
    pipe = lm_pipeline(dc, start_step=start_step)
    monitor = StragglerMonitor()
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None

    losses = []
    try:
        for step, batch in pipe:
            if step >= args.steps:
                break
            batch = to_device(batch, dev)
            with monitor.step_timer():
                params, opt_state, metrics = train_step(params, opt_state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
            losses.append(metrics["loss"])
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"gnorm {metrics['grad_norm']:.3f} lr {metrics['lr']:.2e} "
                      f"median_step {monitor.stats()['median_s']*1e3:.0f}ms",
                      flush=True)
            if saver and (step + 1) % args.ckpt_every == 0:
                saver.save(step + 1, {"params": params, "opt": opt_state})
    finally:
        pipe.close()
        if saver:
            saver.wait()

    first = np.mean(losses[: max(len(losses) // 5, 1)])
    last = np.mean(losses[-max(len(losses) // 5, 1):])
    print(f"loss first-mean {first:.4f} -> last-mean {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
