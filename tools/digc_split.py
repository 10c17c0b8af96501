#!/usr/bin/env python3
"""Split the DIGC kernel's time on the card into sections, from
``clock64()`` stamps in a copy of its source.

    python3 tools/digc_split.py --source path/to/stamped/digc_topk.cu

The stamped copy is a throwaway: the kernel that is committed carries no
stamps. In the copy, thread 0 of every block of the bitonic kernel
(``digc_topk_kernel``) adds the cycles of each section with
``SPLIT_ADD(i, cycles)``, which this script defines (with the counters)
ahead of the copy's text before it builds it. The sections, by index:

  0 staging   loading the operands into shared memory and the barrier
              after it (in the ring kernel: the wait for a piece);
  1 product   the distance product and the norms;
  2 epilogue  bias, masks and the tile's store to shared memory;
  3 merge     the merge of the tile into the lists and its barrier;
  4 chunk     the whole walk over the co-node chunks;
  5 block     the whole block, from its first list write to its output.

The report is the mean per block at three shapes (B = 8 iso, pyr stage
0, the causal KNN shape), in cycles and in microseconds at the SM clock,
beside the stamped kernel's event time (the stamps cost a few cycles and
one atomic per section and block). Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import testing  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "digc_split"
SECTIONS = ("staging", "product", "epilogue", "merge", "chunk", "block")

# Shapes (B, N, M, D, kd, causal): the iso shape, pyr stage 0, the causal
# KNN attention shape.
SHAPES = [(8, 196, 196, 192, 18, False), (8, 3136, 196, 48, 9, False),
          (4, 2048, 2048, 32, 32, True)]

HEADER = """
__device__ unsigned long long g_split[6];
extern "C" int split_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));
}
extern "C" int split_reset() {
  unsigned long long z[6] = {0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_split, z, sizeof(z));
}
#define SPLIT_ADD(i, v) do { if (threadIdx.x == 0) atomicAdd(&g_split[i], (unsigned long long)(v)); } while (0)
"""


def build(source: Path) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "digc_split.cu"
    cu.write_text(HEADER + source.read_text())
    so = OUT / "libdigc_split.so"
    cmd = [_build.nvcc_path(), *_build.ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(so), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.digc_topk_launch.argtypes = _build.SIGNATURES["digc_topk_launch"]
    lib.digc_topk_launch.restype = ctypes.c_int
    return lib


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split(",")
    return float(out[0])


def run_shape(lib, b, n, m, d, kd, causal) -> dict:
    dev = torch.device("cuda", 0)
    x = torch.from_numpy(testing.features(1, b, n, d)).to(dev)
    y = torch.from_numpy(testing.features(2, b, m, d)).to(dev)
    dist = torch.empty((b, n, kd), dtype=torch.float32, device=dev)
    idx = torch.empty((b, n, kd), dtype=torch.int32, device=dev)
    flags = 4 if causal else 0

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.digc_topk_launch(x.data_ptr(), y.data_ptr(), None, 0,
                                    dist.data_ptr(), idx.data_ptr(), b, n, m,
                                    d, kd, flags, 0, 64, 0, 0, m, 16, stream)
        if code:
            raise SystemExit(f"launch failed: CUDA error {code}")

    iters = 50
    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    if lib.split_reset():
        raise SystemExit("split_reset failed")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # queue the launches behind the sleep
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    torch.cuda.synchronize()
    raw = (ctypes.c_ulonglong * 6)()
    if lib.split_read(raw):
        raise SystemExit("split_read failed")
    blocks = -(-n // 16) * b * iters  # 16-row blocks
    per_block = {s: raw[i] / blocks for i, s in enumerate(SECTIONS)}
    return {"shape": [b, n, m, d, kd], "causal": causal,
            "event_us": start.elapsed_time(end) / iters * 1e3,
            "blocks": blocks // iters, "cycles_per_block": per_block}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, required=True,
                    help="a copy of digc_topk.cu with SPLIT_ADD stamps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    lib = build(args.source)
    mhz = sm_clock_mhz()
    print(f"{smi}; max SM clock {mhz:.0f} MHz; source {args.source}")
    rows = []
    for shape in SHAPES:
        r = run_shape(lib, *shape)
        c = r["cycles_per_block"]
        merge = c["merge"]
        split = {"staging": c["staging"], "product": c["product"],
                 "epilogue": c["epilogue"], "merge": merge,
                 "chunk_rest": c["chunk"] - c["staging"] - c["product"]
                 - c["epilogue"] - merge,
                 "other": c["block"] - c["chunk"]}
        total = c["block"]
        print(f"B,N,M,D,kd={r['shape']} causal={r['causal']}: instrumented "
              f"kernel {r['event_us']:.1f} us, {r['blocks']} blocks, "
              f"{total:.0f} cycles per block ({total / mhz:.2f} us at "
              f"{mhz:.0f} MHz)")
        for name, cyc in split.items():
            print(f"  {name:10s} {cyc:10.0f} cycles {cyc / mhz:8.2f} us "
                  f"{100 * cyc / total:5.1f}%")
        rows.append({**r, "split_cycles": split, "sm_mhz": mhz})
    print(json.dumps({"card": smi, "split": rows}))


if __name__ == "__main__":
    main()
