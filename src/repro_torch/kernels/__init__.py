"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version, plus the ``cuda`` GraphBuilder (``ops.py``). Importing
this package builds nothing: the kernels compile at their first launch."""

import contextlib

from repro_torch.kernels import digc_topk, moe_experts, mrconv


def launch_counts() -> dict[str, int]:
    """Kernel launches in this process, by kernel: ``digc_topk`` counts
    every launch of the DIGC kernel, ``digc_topk.<variant>`` those with
    that variant switched on (a packed bf16 launch counts under both),
    ``moe_experts`` each call of the routed expert kernel."""
    counts = {"digc_topk": digc_topk.digc_topk_launches}
    counts.update({f"digc_topk.{v}": n
                   for v, n in digc_topk.variant_launches.items()})
    counts["mrconv"] = mrconv.mrconv_launches
    counts["moe_experts"] = moe_experts.moe_experts_launches
    return counts


def reset_launch_counts() -> None:
    digc_topk.digc_topk_launches = 0
    digc_topk.variant_launches = dict.fromkeys(digc_topk.VARIANTS, 0)
    mrconv.mrconv_launches = 0
    moe_experts.moe_experts_launches = 0


def add_launch_counts(tally: dict[str, int]) -> None:
    """Add a tally (``launch_counts()``'s keys, missing keys 0) to the
    counters: a replayed CUDA graph launches the kernels it recorded
    without calling their wrappers."""
    digc_topk.digc_topk_launches += tally.get("digc_topk", 0)
    for v in digc_topk.VARIANTS:
        digc_topk.variant_launches[v] += tally.get(f"digc_topk.{v}", 0)
    mrconv.mrconv_launches += tally.get("mrconv", 0)
    moe_experts.moe_experts_launches += tally.get("moe_experts", 0)


@contextlib.contextmanager
def uncounted_launches():
    """Yield a dict that receives the launches the wrappers counted inside
    the block, which are taken back out of the counters. A CUDA graph
    capture calls the wrappers but launches nothing: its tally is added
    at each replay instead."""
    before = launch_counts()
    tally: dict[str, int] = {}
    try:
        yield tally
    finally:
        after = launch_counts()
        tally.update({k: after[k] - before[k] for k in after
                      if after[k] != before[k]})
        add_launch_counts({k: -v for k, v in tally.items()})
