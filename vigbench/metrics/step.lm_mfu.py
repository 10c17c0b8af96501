"""The whole step's share of the chip's bf16 peak: the model FLOPs of
the tokens the profiled slice's ticks served, counted as the model's
routed work (``lm_shapes``: 2 x the active matrix weights a token, plus
attention over the positions it attends), whatever the program computes,
over the slice's seconds, over 989 TFLOP/s. The ticks' prompts and
decoded rows are read from the program's ``lm.prefill`` and
``lm.decode`` spans; None where it records none."""

from vigbench import lm_readers, lm_shapes

LAYER = "whole step"
MOVES = "latency_p50_ms"


def read(ctx):
    t = ctx.trace
    ticks = lm_readers.slice_ticks(ctx)
    if t is None or t["window_s"] <= 0 or not ticks:
        return None
    flops = 0.0
    for _, kids in ticks:
        for pre in kids.get("lm.prefill", []):
            flops += lm_shapes.prefill_flops(ctx.cfg, lm_readers.attrs(pre)["tokens"])
        for dec in kids.get("lm.decode", []):
            a = lm_readers.attrs(dec)
            flops += lm_shapes.decode_flops(ctx.cfg, len(a["rows"]), a["kv"])
    return 100.0 * flops / t["window_s"] / lm_shapes.PEAK_BF16_FLOPS
