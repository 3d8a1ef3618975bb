"""The port's kernels against their plain versions on the card, at a
small size: the slice through CUDA kernels must equal the slice through
the plain PyTorch versions.  Needs a CUDA device (marker ``gpu``) and
skips without one.  It imports nothing of JAX, so it runs on the card's
machine, which has no JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from cilium_tpu_torch.core.packets import pack_rows
from cilium_tpu_torch.datapath.loader import TorchLoader
from cilium_tpu_torch.monitor import ring as tring
from cilium_tpu_torch.testing import fixtures as tfix

torch.set_num_threads(1)


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    """On a CUDA machine: the slice through the kernels equals the
    slice through the plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_gpu.py --noconftest)")
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts

    w = tfix.build_world(256, 8, ct_capacity=1 << 12, n_v6=16,
                         device="cpu")
    loaders = [TorchLoader(ct_capacity=1 << 12, device=d)
               for d in ("cuda", "cpu")]
    rings = [tring.EventRing.create(1 << 12, device=l.device)
             for l in loaders]
    for l in loaders:
        l.attach(w.policies, w.ipcache, {0: 0}, w.row_map)
    rng = np.random.default_rng(2)
    pool = tfix.wide_flow_pool(w, 256, rng)
    reset_launch_counts()
    for b in range(3):
        packed = pack_rows(tfix.bench_traffic(w, 512, rng))
        hdr = tfix.wide_traffic(pool, 512, rng)
        for i, l in enumerate(loaders):
            rings[i], _ = l.serve_packed(rings[i], packed, 100 + b, b, 0, 0)
            rings[i], _ = l.serve(rings[i], hdr, 100 + b, b)
    got = [tring.ring_drain(r) for r in rings]
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(loaders[0].metrics(), loaders[1].metrics())
    np.testing.assert_array_equal(loaders[0].ct_snapshot(),
                                  loaders[1].ct_snapshot())
    for name in ("datapath_packed", "datapath_wide", "ct_update",
                 "ring_append"):
        assert KERNELS[name].launches > 0
    # the kernel's claim words live with the table, -1 between calls
    assert bool((loaders[0].state.ct.claim == -1).all())
