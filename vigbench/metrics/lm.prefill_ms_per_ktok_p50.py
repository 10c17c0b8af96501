"""The median, over the prompts prefilled in the window before the
profiled slice, of a whole-prompt prefill's time on the card (its
``lm.prefill`` span's ``device_ms``, by CUDA events) per thousand prompt
tokens. None where the program records no LM spans."""

from vigbench import lm_readers
from vigbench.readers import percentile

LAYER = "LM engine (serve/engine.py::ServeEngine.step)"
MOVES = "latency_p95_ms"


def read(ctx):
    per_ktok = []
    for _, kids in lm_readers.host_ticks(ctx):
        for pre in kids.get("lm.prefill", []):
            a = lm_readers.attrs(pre)
            per_ktok.append(a["device_ms"] / (a["tokens"] / 1e3))
    return percentile(per_ktok, 0.5) if per_ktok else None
