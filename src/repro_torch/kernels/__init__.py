"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version, plus the ``cuda`` GraphBuilder (``ops.py``). Importing
this package builds nothing: the kernels compile at their first launch."""

from repro_torch.kernels import digc_topk, mrconv


def launch_counts() -> dict[str, int]:
    """Kernel launches in this process, by kernel: ``digc_topk`` counts
    every launch of the DIGC kernel, ``digc_topk.<variant>`` those with
    that variant switched on (a packed bf16 launch counts under both)."""
    counts = {"digc_topk": digc_topk.digc_topk_launches}
    counts.update({f"digc_topk.{v}": n
                   for v, n in digc_topk.variant_launches.items()})
    counts["mrconv"] = mrconv.mrconv_launches
    return counts


def reset_launch_counts() -> None:
    digc_topk.digc_topk_launches = 0
    digc_topk.variant_launches = dict.fromkeys(digc_topk.VARIANTS, 0)
    mrconv.mrconv_launches = 0
