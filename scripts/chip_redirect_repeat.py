#!/usr/bin/env python3
"""Run phase 8 of ``chip_smoke.py`` (the L7 redirect overhead) many times
on one card, to tell a rare failure of its wait from a fluke.

    python3 scripts/chip_redirect_repeat.py [RUNS]     # default 20

Each run builds its two daemons afresh (the kernels build once, on the
first).  Prints one line a run (pass or the failure, the redirect
leg's hand-over record, the event plane's overflows and drops) and, as
the last line, one JSON object with the counts; exits non-zero if any
run failed.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("chip_redirect_repeat: no CUDA device", file=sys.stderr)
        return 1
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    results = []
    for i in range(runs):
        report = {}
        t0 = time.monotonic()
        try:
            chip_smoke.phase_l7_redirect(torch, report)
            ok, err = True, None
        except chip_smoke.SmokeFailure as e:
            ok, err = False, str(e)
        r = report.get("l7_redirect", {})
        results.append({"run": i, "ok": ok, "error": err,
                        "seconds": time.monotonic() - t0,
                        "handover": r.get("handover"),
                        "ratio_median": r.get("ratio_median")})
        print(f"run {i}: {'pass' if ok else 'FAIL: ' + err} "
              f"({results[-1]['seconds']:.1f} s)")
    failed = sum(not r["ok"] for r in results)
    print(json.dumps({"runs": runs, "failed": failed,
                      "device": torch.cuda.get_device_name(0),
                      "results": results}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
