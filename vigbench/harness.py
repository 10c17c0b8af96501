"""Runs one cell of ``BENCHMARK.json``: set-up, the measured window, the
correctness comparison and the result line.

The harness knows no cell, configuration, mix or metric by name. A cell
names its configuration and its mix; ``configs/<config>.json`` names its
model family (``families/<family>.py``: the system under test, its
warm-up, its plain reference and the comparison with it),
``traffic/<traffic>.json`` its
loop (``traffic.py``), and each metric is read by
``metrics/<metric>.py``, which holds the metric's layer, the end-to-end
metric it moves and its reader ``read(ctx)`` (None: nothing to read, and
the metric is left out of the line).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = ROOT / "results" / "vigbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GRACE_S = 60.0  # how long past the window a due request is waited for
CLOSED_UIDS = 1 << 22  # image draws ready for a closed loop's requests


class NoCard(RuntimeError):
    """The cell's measurement needs CUDA cards that this host lacks."""


# -- finding things by name ----------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> tuple[dict, dict]:
    """The workload entry and its configuration entry."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metric entries a run of this cell reports: the end-to-end ones
    untraced, the per-layer ones traced; a metric with ``workloads``
    only in the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def load_metric(name: str):
    """``metrics/<name>.py`` as a module (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vigbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_family(name: str):
    return importlib.import_module(f"vigbench.families.{name}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- the measured window -------------------------------------------------


@dataclasses.dataclass
class Request:
    uid: int
    item: int           # the input's index in the cell's pool
    due: float          # when it was due (open) or sent (closed)
    start: Optional[float] = None  # start of the tick that served it
    done: Optional[float] = None   # when its answer was on the host
    answer: object = None  # None: no answer
    lane: object = None  # where the system computed the answer (the family's)
    failed: bool = False


@dataclasses.dataclass
class Window:
    start: float
    seconds: float
    requests: list      # every request the window offered
    ticks: list         # (start, end, served, bucket, queued before) per tick
    lateness_s: float = 0.0  # the latest submission past its due time
    host_until: Optional[float] = None  # set when a traced slice began

    @property
    def end(self) -> float:
        return self.start + self.seconds

    def host_ticks(self) -> list:
        """The ticks whose host time is undisturbed by the profiler."""
        until = self.end if self.host_until is None else self.host_until
        return [t for t in self.ticks if t[1] <= until]

    def host_requests(self) -> list:
        """The requests due before the profiler started, if it did."""
        until = self.end if self.host_until is None else self.host_until
        return [r for r in self.requests if r.due < until]


def _finish(reqs: dict, done: list, t0: float, t1: float) -> None:
    for uid, answer, lane in done:
        r = reqs[uid]
        r.start, r.done = t0, t1
        r.answer, r.lane = answer, lane
        r.failed = answer is None


def _tick(system, reqs, ticks, window_start, seconds, tracer):
    """One engine tick, timed on the host; recorded if it began inside
    the window."""
    queued = system.queued()
    if tracer is not None:
        tracer.before(time.perf_counter(), window_start, seconds)
    t0 = time.perf_counter()
    done = system.step()
    t1 = time.perf_counter()
    if tracer is not None:
        tracer.after(system.last_bucket(), len(done))
    _finish(reqs, done, t0, t1)
    if t0 < window_start + seconds:
        ticks.append((t0, t1, len(done), system.last_bucket(), queued))
    return len(done)


def closed_loop(system, mix: dict, seconds: float, seed: int, pool: int,
                tracer=None) -> Window:
    """Keep ``outstanding`` requests in flight for ``seconds``; then
    drain what is left (compared, not counted)."""
    from vigbench import traffic

    items = traffic.closed_items(seed, pool, CLOSED_UIDS)
    reqs: dict[int, Request] = {}
    ticks: list = []

    def send(n: int, now: float) -> None:
        for _ in range(n):
            uid = len(reqs)
            reqs[uid] = Request(uid=uid, item=int(items[uid]), due=now)
            system.submit(uid, reqs[uid].item)

    start = time.perf_counter()
    end = start + seconds
    send(int(mix["outstanding"]), start)
    while time.perf_counter() < end:
        served = _tick(system, reqs, ticks, start, seconds, tracer)
        send(served, time.perf_counter())
    while system.queued():
        _tick(system, reqs, ticks, start, seconds, tracer)
    return Window(start=start, seconds=seconds, requests=list(reqs.values()),
                  ticks=ticks)


def open_loop(system, mix: dict, seconds: float, seed: int, pool: int,
              tracer=None) -> Window:
    """Submit each request at its due time, whatever the queue holds; a
    tick runs whenever requests wait. Requests due in the window are
    waited for up to ``GRACE_S`` past its end; one that never comes has
    failed."""
    from vigbench import traffic

    due, items = traffic.open_schedule(mix, seconds, seed, pool)
    reqs: dict[int, Request] = {}
    ticks: list = []
    start = time.perf_counter()
    end, give_up = start + seconds, start + seconds + GRACE_S
    late, i, n = 0.0, 0, len(due)
    while True:
        now = time.perf_counter()
        if now > give_up:
            break
        while i < n and start + due[i] <= now:
            reqs[i] = Request(uid=i, item=int(items[i]), due=start + float(due[i]))
            system.submit(i, reqs[i].item)
            late = max(late, now - reqs[i].due)
            i += 1
        if system.queued():
            _tick(system, reqs, ticks, start, seconds, tracer)
        elif i < n:
            time.sleep(max(0.0, start + float(due[i]) - time.perf_counter()))
        else:
            break
    for r in reqs.values():
        if r.done is None:
            r.failed = True
    for j in range(i, n):  # never submitted: the generator fell a minute behind
        reqs[j] = Request(uid=j, item=int(items[j]),
                          due=start + float(due[j]), failed=True)
    return Window(start=start, seconds=seconds, requests=list(reqs.values()),
                  ticks=ticks, lateness_s=late)


LOOPS = {"closed": closed_loop, "open": open_loop}


# -- one run -------------------------------------------------------------


@dataclasses.dataclass
class Context:
    """What a metric's reader sees."""

    cfg: dict
    mix: dict
    window: Window
    setup_s: float
    trace: Optional[dict]


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoCard(f"this cell needs {n} CUDA card(s); found {found}")


def card(device) -> dict:
    """The card's name and count, and its power limit from nvidia-smi."""
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30)
        out["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["power_limit"] = f"unread: {e!r}"
    return out


def run_cell(*, cfg: dict, mix: dict, limits: dict, metrics: list[dict],
             seed: int, seconds: float, trace: bool, device, t_process: float,
             trace_path: Optional[Path] = None) -> dict:
    """One run: set-up, window, comparison, metrics. Returns the result
    line as a dict (``checks`` last)."""
    import gc

    import torch

    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["allow_tf32"])
    family = load_family(cfg["family"])
    on_card = torch.device(device).type == "cuda"
    weights, pool_dev, pool_host = family.setup(cfg, seed, device)
    system = family.System(cfg, weights, pool_host, device)
    pool = pool_host.shape[0]
    family.warm(system, mix, pool)
    tracer = None
    if trace:
        from vigbench import trace as tracing

        tracing.warm_profiler()
        tracer = tracing.Slice(mix["trace_from"], mix["trace_ticks"],
                               trace_path or OUT / "trace.json")
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    build_s = family.build_seconds() if on_card else None
    window = LOOPS[mix["loop"]](system, mix, seconds, seed, pool, tracer)
    if tracer is not None:
        tracer.finish()
        window.host_until = tracer.started
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del system, weights, pool_dev, pool_host
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reduced = tracer.reduce() if tracer is not None else None
    # The reference works from its own draw of the seed's weights and
    # images: nothing the program held is read again.
    ref_weights, ref_pool, _ = family.setup(cfg, seed, device)
    ref = family.reference(cfg, ref_weights, ref_pool)
    checks = family.compare(window, ref, limits)
    ctx = Context(cfg=cfg, mix=mix, window=window, setup_s=setup_s,
                  trace=reduced)
    values = {}
    for m in metrics:
        mod = load_metric(m["name"])
        if mod.LAYER != m.get("layer", mod.LAYER) or mod.MOVES != m.get("moves", mod.MOVES):
            raise ValueError(f"metrics/{m['name']}.py names layer {mod.LAYER!r} "
                             f"moving {mod.MOVES!r}; BENCHMARK.json says "
                             f"{m.get('layer')!r} moving {m.get('moves')!r}")
        v = mod.read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = card(device)
    dev["memory_peak_bytes"] = int(peak)
    if reduced is not None:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
    offered = window.requests
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(offered),
        "failed": sum(1 for r in offered if r.failed),
        "metrics": values,
        "device": dev,
    }
    if reduced is not None:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["lateness_s"] = window.lateness_s
    result["kernel_build_s"] = build_s
    result["checks"] = checks
    return result


def main(argv: list[str], t_process: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, conf = find_cell(bench, args.workload)
    try:
        require_cards(int(cell["chips"]))
    except NoCard as e:
        print(f"vigbench: {e}", file=sys.stderr)
        return 2
    cfg = load_json(ROOT / conf["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{conf['name']}.json")
    trace_path = OUT / f"{args.workload}.seed{args.seed}.trace.json"
    result = run_cell(cfg=cfg, mix=mix, limits=limits,
                      metrics=cell_metrics(bench, args.workload, bool(args.trace)),
                      seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_process=t_process, trace_path=trace_path)
    found = forbidden_modules()
    if found:
        print(f"vigbench: the run loaded {found}; the benchmark may load "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
