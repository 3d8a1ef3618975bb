#!/usr/bin/env python3
"""Split K21 ``anomaly_train_bwd`` (and K21s over 8 shards) into its
passes on the card, and time K10 ``dus`` beside a slice ``copy_``, for
one or more checkouts of this repository.

    python3 scripts/chip_kernel_split.py [TREE ...]   # default: this one

Each TREE is a checkout (a ``git archive`` of another commit unpacked
in a directory that ``.gitignore`` lists will do); each runs in its own
process, in the order given, so ``A B B A`` compares two commits in
turns on one card.  A run builds the tree's kernels, makes phase 3's
train batch (``chip_smoke.train_inputs``: B = 4096 rows at config #3,
V = 16384, one identity on half the rows, ids past V and negative) and
prints, for S = 1 and S = 8:

- the device ms a launch of each kernel (and memset) of K21, from
  ``torch.profiler`` over 20 launches, and the kernels a launch;
- K21's time a launch (CUDA events, ``chip_smoke.device_ms``, 20);

then K10 at config #3's verdict row, auth column and an l3 row, each
beside the slice ``copy_`` of the same update, in the same process.
Each run writes ``chiprun_out/split/<label>.json`` and its d_embed
(``.pt``); a later run holds its d_embed against every earlier run's,
bit for bit, and prints the cells that differ.  The line before the
last is the card's name and power limit (nvidia-smi); the last line
is one JSON object with every run.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "split"
REPS = 20
SEED = 20261017  # chip_smoke's


def split_one(tree: Path, label: str) -> dict:
    """One tree, in this process: build, split K21/K21s, time K10."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from cilium_tpu_torch.datapath.loader import (TorchLoader, _dus,
                                                  _dus_starts)
    from cilium_tpu_torch.kernels import (build, launch_anomaly_train_bwd,
                                          launch_anomaly_train_fwd)
    from cilium_tpu_torch.testing.fixtures import build_world

    t0 = time.monotonic()
    build.build()
    res = {"tree": str(tree), "label": label,
           "build_s": time.monotonic() - t0, "k21": {}, "k10": {}}
    rng = np.random.default_rng(SEED)
    world = build_world(10_000, 64, ct_capacity=1 << 4, n_v6=256,
                        device="cpu")
    ids, feats, labels = cs.train_inputs(torch, rng, world)
    leaves = cs.train_model(torch, world).leaves()
    gloss = torch.ones(1, device="cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    for s in (None, 8):
        _, saved = launch_anomaly_train_fwd(leaves, ids, feats, labels, s)

        def bwd():
            return launch_anomaly_train_bwd(leaves, saved, ids, labels,
                                            gloss, s)

        grads = bwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                bwd()
            torch.cuda.synchronize()
        passes = {e.key: {"ms": e.self_device_time_total / 1e3 / REPS,
                          "calls": e.count / REPS}
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("Activity Buffer")
                  and e.self_device_time_total > 0}
        ms = cs.device_ms(bwd, REPS)
        name = f"S{s or 1}"
        torch.save(grads[0].cpu(), OUT / f"{label}_d_embed_{name}.pt")
        res["k21"][name] = {"ms": ms, "passes": passes,
                            "launches": sum(p["calls"]
                                            for p in passes.values())}
        print(f"[{label}] K21 {name}: {ms:.4f} ms a launch (events); "
              f"{res['k21'][name]['launches']:.0f} kernels and memsets a "
              f"launch; by pass (device ms a launch):")
        for k, p in sorted(passes.items(), key=lambda kv: -kv[1]["ms"]):
            print(f"  {k[:60]}: {p['ms']:.4f} ({p['calls']:.0f} a launch)")
        for other in sorted(OUT.glob(f"*_d_embed_{name}.pt")):
            if other.name.startswith(f"{label}_"):
                continue
            want = torch.load(other)
            got = grads[0].cpu()
            diff = int((got != want).sum())
            res["k21"][name][f"differs_from_{other.name}"] = diff
            print(f"  d_embed against {other.name}: {diff} cells differ, "
                  f"max abs {float((got - want).abs().max()):.3g}")

    kl = TorchLoader(ct_capacity=1 << 4, device="cuda")
    kl.attach(world.policies, world.ipcache, {0: 0}, world.row_map)
    pol, lpm = kl.state.policy, kl.state.ipcache
    n_pol, _, n_rows, n_local = pol.verdict.shape
    row = n_rows // 4 + 1

    def rand(*shape):
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).cuda()

    for what, dst, upd, starts in (
            ("verdict row", pol.verdict, rand(n_pol, 2, 1, n_local),
             (0, 0, row, 0)),
            ("auth column", pol.auth, rand(n_pol, 1), (0, row)),
            ("l3 row", lpm.l3, rand(1, 256), (lpm.l3.shape[0] // 2, 0))):
        dst = dst.clone()
        idx = tuple(slice(a, a + u) for a, u in zip(
            _dus_starts(dst.shape, upd.shape, starts), upd.shape))
        # kernel, copy_, copy_, kernel
        t = [cs.device_ms(lambda: _dus(dst, upd, starts), REPS),
             cs.device_ms(lambda: dst[idx].copy_(upd), REPS),
             cs.device_ms(lambda: dst[idx].copy_(upd), REPS),
             cs.device_ms(lambda: _dus(dst, upd, starts), REPS)]
        res["k10"][what] = {"shape": list(upd.shape),
                            "dst": list(dst.shape), "ms": [t[0], t[3]],
                            "copy_ms": [t[1], t[2]]}
        print(f"[{label}] K10 {what} {tuple(upd.shape)} into "
              f"{tuple(dst.shape)}: {t[0]:.4f} / {t[3]:.4f} ms; slice "
              f"copy_ {t[1]:.4f} / {t[2]:.4f} ms")
    (OUT / f"{label}.json").write_text(json.dumps(res, indent=1))
    return res


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--one":
        split_one(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_split: no CUDA device", file=sys.stderr)
        return 1
    trees = [Path(t).resolve() for t in sys.argv[1:]] or [ROOT]
    runs = []
    for i, tree in enumerate(trees):
        label = f"{i}_{tree.name}"
        p = subprocess.run([sys.executable, __file__, "--one", str(tree),
                            label], timeout=900)
        if p.returncode != 0:
            print(f"chip_kernel_split: {tree} failed ({p.returncode})",
                  file=sys.stderr)
            return 1
        runs.append(json.loads((OUT / f"{label}.json").read_text()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi,
                      "runs": [{k: r[k] for k in ("label", "k21", "k10")}
                               for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
