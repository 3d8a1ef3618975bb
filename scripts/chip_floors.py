#!/usr/bin/env python3
"""Time the fixed costs a one-launch kernel design pays on the card: an
empty launch, a cooperative launch with 0, 1 or 2 grid barriers
(``cooperative_groups`` ``grid.sync()``) and an 8-block cluster launch
with 0, 1 or 3 cluster barriers (``cluster.sync()``), at a few grid
shapes, each the mean of 200 launches queued behind a spin kernel
(CUDA events; the host's enqueue is not in the window).

    python3 scripts/chip_floors.py

K18 (``csrc/ml.cu``) chose its two kernels from these floors.  Builds
its own small library with ``nvcc`` into ``chiprun_out/floors/``.  The
line before the last is the card's name and power limit (nvidia-smi);
the last line is one JSON object with every time in microseconds.
Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "floors"
REPS = 200
SOURCE = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void plain_k() {}
template <int SYNCS> __global__ void __cluster_dims__(8, 1, 1) cluster_k() {
  cg::cluster_group c = cg::this_cluster();
  for (int i = 0; i < SYNCS; ++i) c.sync();
}
template <int SYNCS> __global__ void coop_k() {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < SYNCS; ++i) g.sync();
}
extern "C" int launch(int which, int blocks, int threads, cudaStream_t s) {
  void* none[1] = {nullptr};
  switch (which) {
    case 0: plain_k<<<blocks, threads, 0, s>>>(); break;
    case 1: cluster_k<0><<<blocks, threads, 0, s>>>(); break;
    case 2: cluster_k<1><<<blocks, threads, 0, s>>>(); break;
    case 3: cluster_k<3><<<blocks, threads, 0, s>>>(); break;
    case 4: return (int)cudaLaunchCooperativeKernel(
        (void*)coop_k<0>, blocks, threads, none, 0, s);
    case 5: return (int)cudaLaunchCooperativeKernel(
        (void*)coop_k<1>, blocks, threads, none, 0, s);
    case 6: return (int)cudaLaunchCooperativeKernel(
        (void*)coop_k<2>, blocks, threads, none, 0, s);
  }
  return (int)cudaGetLastError();
}
"""
CASES = ("launch", "cluster8, 0 barriers", "cluster8, 1 barrier",
         "cluster8, 3 barriers", "cooperative, 0 barriers",
         "cooperative, 1 barrier", "cooperative, 2 barriers")
SHAPES = ((8, 1024), (16, 256), (16, 512), (132, 512))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_floors: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cilium_tpu_torch.kernels.build import nvcc_path

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "floors.cu").write_text(SOURCE)
    subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(OUT / "floors.so"), str(OUT / "floors.cu")],
                   check=True)
    lib = ctypes.CDLL(str(OUT / "floors.so"))
    lib.launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = {}
    for which, case in enumerate(CASES):
        for blocks, threads in SHAPES:
            if 1 <= which <= 3 and blocks % 8:
                continue
            err = lib.launch(which, blocks, threads, stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{case} {blocks}x{threads}: CUDA error "
                                   f"{err}")
            torch.cuda._sleep(300_000_000)
            start.record()
            for _ in range(REPS):
                lib.launch(which, blocks, threads, stream)
            end.record()
            torch.cuda.synchronize()
            us = start.elapsed_time(end) / REPS * 1e3
            times[f"{case}, {blocks}x{threads}"] = us
            print(f"{case}, {blocks} blocks x {threads}: {us:.2f} us")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "us": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
