"""NaN-debug smoke of the reference tier (the twin of
``examples/nan_smoke.py``).

Runs the reference DIGC builder and a tiny stateful ViG forward (a cold
then a warm tick through the functional state) with well-conditioned
inputs, every operation under ``NanCheck``: the counterpart of
``JAX_DEBUG_NANS``, a dispatch mode that raises on the first floating
operation whose output is not finite. It shows the fault-free reference
path makes no NaN or Inf anywhere in its compute, the baseline the
serving guards' finiteness screens are calibrated against.

    PYTHONPATH=src python -m repro_torch.examples.nan_smoke [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import DigcSpec, digc
from repro_torch.device import resolve_device
from repro_torch.models import vig
from repro_torch.models.convert import init_params

# Allocation only: uninitialized memory may hold NaN bit patterns before
# an operation writes it.
_ALLOC = ("empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided")


class NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` naming the operation on the first
    floating output with a NaN or Inf (one device read an operation)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _ALLOC:
            return out
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for o in outs:
            if (isinstance(o, torch.Tensor) and o.is_floating_point()
                    and not bool(torch.isfinite(o).all())):
                raise FloatingPointError(f"non-finite output of {func}")
        return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"NanCheck on every operation ({dev})")
    rng = np.random.default_rng(0)

    with NanCheck():
        # --- reference DIGC, twice -------------------------------------
        feats = torch.as_tensor(rng.standard_normal((2, 64, 32)),
                                dtype=torch.float32, device=dev)
        spec = DigcSpec(impl="reference", k=4, dilation=2)
        idx = digc(feats, spec=spec)
        if not torch.equal(idx, digc(feats, spec=spec)):
            raise AssertionError("two reference calls differ")
        print(f"reference DIGC: idx {tuple(idx.shape)}, two calls equal")

        # --- tiny ViG forward, cold then warm state tick ---------------
        cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(
            image_size=16, patch=4, embed_dims=(16,), depths=(2,),
            num_classes=3, k=3, digc_impl="reference")
        params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        state = vig.init_vig_state(cfg, 2, "reference", device=dev)
        images = torch.as_tensor(rng.standard_normal((2, 16, 16, 3)),
                                 dtype=torch.float32, device=dev)
        for tick in (1, 2):
            with torch.no_grad():
                logits, state = vig.vig_forward(params, images, cfg,
                                                digc_impl="reference", state=state)
            print(f"ViG tick {tick}: logits {tuple(logits.shape)} all finite")
    print("NAN_SMOKE_OK")


if __name__ == "__main__":
    main()
