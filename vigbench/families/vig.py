"""The ViG family: ``repro_torch``'s ``VigServeEngine`` serving one-shot
image requests through captured bucket programs.

The benchmark makes the weights and the image pool from the seed, on the
device, and hands the same tensors to the program and to the plain
reference. Parameter paths are the program's (``stage0/block0/fc_in``;
dense weights stored (in, out)).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def param_shapes(cfg: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Path -> (shape, init): ``fanin`` draws N(0, 1 / shape[0]),
    ``normal`` N(0, 0.02^2), ``ones`` is ones."""
    dims, p = cfg["embed_dims"], int(cfg["patch"])
    grid = int(cfg["image_size"]) // p
    ffn = int(cfg["ffn_ratio"])
    out = {
        "stem": ((p * p * int(cfg["in_chans"]), dims[0]), "fanin"),
        "pos": ((grid * grid, dims[0]), "normal"),
        "head": ((dims[-1], int(cfg["num_classes"])), "fanin"),
    }
    for si, (d, depth) in enumerate(zip(dims, cfg["depths"])):
        for bi in range(depth):
            pre = f"stage{si}/block{bi}/"
            out.update({
                pre + "ln_g/scale": ((d,), "ones"),
                pre + "fc_in": ((d, d), "fanin"),
                pre + "fc_graph": ((2 * d, d), "fanin"),
                pre + "fc_out": ((d, d), "fanin"),
                pre + "ln_f/scale": ((d,), "ones"),
                pre + "fc1": ((d, ffn * d), "fanin"),
                pre + "fc2": ((ffn * d, d), "fanin"),
            })
        if si + 1 < len(dims):
            out[f"down{si}"] = ((4 * d, dims[si + 1]), "fanin")
    return out


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """Seeded fp32 weights, drawn on the generator's device in one call
    and cut into leaves in sorted path order."""
    shapes = param_shapes(cfg)
    drawn = [path for path in sorted(shapes) if shapes[path][1] != "ones"]
    sizes = [math.prod(shapes[path][0]) for path in drawn]
    flat = torch.randn(sum(sizes), generator=gen, device=gen.device)
    out = {}
    for path, part in zip(drawn, torch.split(flat, sizes)):
        shape, init = shapes[path]
        sd = 0.02 if init == "normal" else 1.0 / math.sqrt(shape[0])
        out[path] = (part * sd).reshape(shape).to(device)
    for path, (shape, init) in shapes.items():
        if init == "ones":
            out[path] = torch.ones(shape, device=device)
    return out


def make_images(cfg: dict, count: int, gen: torch.Generator, device) -> torch.Tensor:
    """(count, H, W, C) fp32 images: a smooth random field (noise on a
    1/16 grid, upsampled bilinearly) with per-image channel offsets and
    contrast, plus pixel noise, so that images differ in content."""
    size, c = int(cfg["image_size"]), int(cfg["in_chans"])
    low = max(size // 16, 2)
    dev = gen.device
    coarse = torch.randn(count, c, low, low, generator=gen, device=dev)
    field = torch.nn.functional.interpolate(coarse, size=(size, size),
                                            mode="bilinear", align_corners=False)
    offset = torch.randn(count, c, 1, 1, generator=gen, device=dev) * 0.5
    contrast = torch.rand(count, 1, 1, 1, generator=gen, device=dev) + 0.5
    noise = torch.randn(count, c, size, size, generator=gen, device=dev) * 0.25
    imgs = field * contrast + offset + noise
    return imgs.permute(0, 2, 3, 1).contiguous().to(device)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, val in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = val
    return tree


class System:
    """The program under test: one ``VigServeEngine`` on ``device``.
    ``submit(uid, image_index)`` queues a one-shot request; ``step()``
    runs one engine tick and returns the requests it finished."""

    def __init__(self, cfg: dict, weights: dict, pool_host: np.ndarray, device):
        from repro_torch.models.vig import VigConfig
        from repro_torch.serve.engine import VigRequest, VigServeEngine

        self._request = VigRequest
        vcfg = VigConfig(
            name=cfg["name"], variant=cfg["variant"],
            image_size=int(cfg["image_size"]), patch=int(cfg["patch"]),
            in_chans=int(cfg["in_chans"]), embed_dims=tuple(cfg["embed_dims"]),
            depths=tuple(cfg["depths"]), reduce_ratios=tuple(cfg["reduce_ratios"]),
            k=int(cfg["k"]), max_dilation=int(cfg["max_dilation"]),
            use_dilation=bool(cfg["use_dilation"]),
            num_classes=int(cfg["num_classes"]), digc_impl=cfg["digc_impl"],
            ffn_ratio=int(cfg["ffn_ratio"]))
        self.engine = VigServeEngine(
            vcfg, _unflatten(weights), digc_impl=cfg["digc_impl"],
            batch=max(cfg["buckets"]), buckets=tuple(cfg["buckets"]),
            mode="jit", guards=bool(cfg["guards"]), slo_ms=float(cfg["slo_ms"]),
            device=device)
        self.pool = pool_host
        self._pending: dict[int, object] = {}

    def submit(self, uid: int, image_index: int) -> None:
        req = self._request(uid=uid, image=self.pool[image_index], tenant=None)
        self.engine.submit(req)
        self._pending[uid] = req

    def queued(self) -> int:
        return len(self.engine.queue)

    def step(self) -> list:
        """One engine tick. Each finished request comes back as ``(uid,
        logits or None if it failed, lane)``: the lane is ``(bucket,
        row)``, the row of the bucket program that computed the answer.
        The engine binds one-shot requests to free slots in queue order
        and runs its lanes in slot order, so the row is the answer's
        place among the tick's answers."""
        before = list(self.engine.queue)
        self.engine.step()
        bucket = self.engine.last_bucket
        out, row = [], 0
        for req in before:
            if not req.done:
                continue
            del self._pending[req.uid]
            if req.fault is not None:
                out.append((req.uid, None, None))
            else:
                out.append((req.uid, req.logits, (bucket, row)))
                row += 1
        return out

    def last_bucket(self):
        return self.engine.last_bucket


def build_seconds() -> float:
    """The seconds the program took to build its CUDA kernels in this
    process (a part of set-up); call after a kernel has run on a card."""
    from repro_torch.kernels import _build

    return _build.load().build_seconds


def setup(cfg: dict, seed: int, device):
    """(weights, device image pool, host image pool) from the seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    weights = make_weights(cfg, gen, device)
    pool = make_images(cfg, int(cfg["pool_images"]), gen, device)
    return weights, pool, pool.cpu().numpy()


def warm(system: System, mix: dict, pool: int) -> None:
    """Serve each bucket the mix uses (``warm_buckets``) twice: the first
    tick builds and captures its program, the second replays it."""
    uid = -1
    for b in mix["warm_buckets"]:
        for _ in range(2):
            for _ in range(b):
                system.submit(uid, uid % pool)
                uid -= 1
            while system.queued():
                system.step()


def reference(cfg: dict, weights: dict, pool: torch.Tensor,
              precision: str = "fp32") -> np.ndarray:
    """The plain reference's logits of every pool image, in blocks of
    ``reference_block`` images, on the pool's device."""
    from vigbench.reference import vig_plain

    block = int(cfg["reference_block"])
    with torch.inference_mode():
        return torch.cat([vig_plain.forward(weights, pool[i:i + block], cfg,
                                            precision=precision).cpu()
                          for i in range(0, pool.shape[0], block)]).numpy()


def answer_gaps(window, ref: np.ndarray) -> tuple[dict, int]:
    """Per lane, the gap of each answer it gave: the largest absolute
    difference between the answer's logits and the reference's logits of
    its image, over the reference's largest absolute logit; and the
    number of requests never answered."""
    by_lane: dict = {}
    missing = 0
    for r in window.requests:
        if r.failed or r.answer is None:
            missing += 1
            continue
        want = ref[r.item]
        gap = float(np.abs(r.answer - want).max() / np.abs(want).max())
        by_lane.setdefault(r.lane, []).append(gap)
    return by_lane, missing


def lane_quartiles(by_lane: dict, least: int) -> dict:
    """The first quartile of the gaps of each lane that gave at least
    ``least`` answers; the answers of the other lanes form one more
    group, held too if it reaches ``least`` or if no lane does."""
    out, rest = {}, []
    for lane, gaps in by_lane.items():
        if len(gaps) >= least:
            out[lane] = float(np.quantile(gaps, 0.25))
        else:
            rest += gaps
    if rest and (len(rest) >= least or not out):
        out["other lanes"] = float(np.quantile(rest, 0.25))
    return out


def compare(window, ref: np.ndarray, limits: dict) -> dict:
    """Every request the window offered against the reference: the answers
    that never came (``missing``) and, over the lanes of the bucket
    programs, the largest first quartile of a lane's gaps
    (``gap_q25_worst_lane``). Returns ``{name: {"value", "limit"}}``.

    A quartile, not the largest gap or the median: at these widths a
    share of the images (a third to a half of them, more on some seeds)
    pass a neighbour-set boundary within fp32's rounding, and each choice
    there changes every later layer, so on those images two sound fp32
    programs differ by as much as a TF32 one does; the rest agree to
    rounding. Which images those are does not depend on the lane that
    serves them, so every lane's quartile stays at rounding in a sound
    run, and a fault in any lane that serves ``lane_min_answers`` or
    more answers (half a bucket's lanes, one bucket program) shows."""
    by_lane, missing = answer_gaps(window, ref)
    q = lane_quartiles(by_lane, int(limits["lane_min_answers"]))
    numbers = {"missing": float(missing),
               "gap_q25_worst_lane": max(q.values()) if q else math.inf}
    return {k: {"value": v, "limit": float(limits[k])} for k, v in numbers.items()}


def held(window, ref: np.ndarray, limits: dict) -> dict:
    """The numbers ``compare`` holds (``missing``, ``gap_q25_worst_lane``)
    with what they are read from: the lanes held, the fewest answers in a
    lane, and quartiles and the largest of every answer's gap."""
    by_lane, missing = answer_gaps(window, ref)
    gaps = [g for lane in by_lane.values() for g in lane]
    q = lane_quartiles(by_lane, int(limits["lane_min_answers"]))
    quart = np.quantile(gaps, [0.25, 0.5, 0.75])
    return {"missing": missing, "gap_q25_worst_lane": max(q.values()),
            "lanes_held": len(q),
            "least_answers_in_a_lane": min(len(g) for g in by_lane.values()),
            "gap_q25": float(quart[0]), "gap_median": float(quart[1]),
            "gap_q75": float(quart[2]), "gap_max": max(gaps)}


def controls(cfg: dict, weights: dict, pool: torch.Tensor, window, ref) -> dict:
    """Windows that ``compare`` must refuse, on the window's own requests:
    the reference in TF32 (one step below the configuration's fp32) put
    in the program's place for each request's image (``control_tf32``),
    and the program's answers with the upper half of every bucket's lanes
    answered by the tick's row 0 (``upper_lanes_other``) or by zeros
    (``upper_lanes_zero``)."""
    from vigbench import control

    low = reference(cfg, weights, pool, "tf32")
    out = {"control_tf32": dataclasses.replace(window, requests=[
        dataclasses.replace(r, answer=low[r.item], failed=False)
        for r in window.requests])}
    for how in ("other", "zero"):
        out[f"upper_lanes_{how}"] = control.broken_window(window, how)
    return out


# The held limit that each of ``controls``' windows must exceed.
CONTROL_BREAKS = {"control_tf32": "gap_q25_worst_lane",
                  "upper_lanes_other": "gap_q25_worst_lane",
                  "upper_lanes_zero": "gap_q25_worst_lane"}
