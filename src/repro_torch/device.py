"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The torch.device an entry point runs on.

    Raises when a CUDA device is asked for on a host without one: the
    CPU path runs only when the caller asks for it with ``device="cpu"``.
    ``device="meta"`` builds shapes and dtypes only (no storage), the
    port's counterpart of ``jax.eval_shape``: the dry-run
    (``launch/dryrun.py``) traces full-size steps that way. No kernel
    runs on a meta tensor (``runs_kernel`` raises).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(
            f"unsupported device {str(device)!r}: use cuda, cpu or meta")
    return dev


def runs_kernel(t: torch.Tensor) -> bool:
    """Kernel dispatch by the tensor's device: True for CUDA (launch the
    kernel or raise), False for CPU (the plain PyTorch version)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensors on {t.device} are not supported: use cuda or cpu")
