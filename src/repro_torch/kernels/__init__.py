"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version, plus the ``cuda`` GraphBuilder (``ops.py``). Importing
this package builds nothing: the kernels compile at their first launch."""

from repro_torch.kernels import digc_topk, mrconv


def launch_counts() -> dict[str, int]:
    """Kernel launches in this process, by kernel."""
    return {"digc_topk": digc_topk.digc_topk_launches,
            "mrconv": mrconv.mrconv_launches}


def reset_launch_counts() -> None:
    digc_topk.digc_topk_launches = 0
    mrconv.mrconv_launches = 0
