"""The seconds the program spent building its CUDA kernels in this
process: the sum of its ``kernels.build`` spans (0.0 where it built
nothing, as on a host without a card). None where the program records no
spans, or its recorder is off."""

LAYER = "set-up (kernels/_build.py::build)"
MOVES = "setup_s"


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    if not spans.RECORDER.enabled:
        return None
    return 1e-9 * sum(s.t1 - s.t0 for s in spans.RECORDER.spans()
                      if s.name == "kernels.build")
