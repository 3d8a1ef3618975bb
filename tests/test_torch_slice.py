"""The first slice end to end: TorchLoader (device="cpu", the plain
PyTorch versions) against TPULoader (JAX on the CPU) through attach,
serve_packed, serve and step on the 10k-identity world cut to 256
identities — drained ring rows, metrics, CT snapshot and step output
bit-exact.  Plus the port's boundaries: it imports nothing of JAX or
the JAX package, and asks for the CPU only when told to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.core.packets import pack_rows
from cilium_tpu.datapath.loader import TPULoader
from cilium_tpu.monitor import ring as jring
from cilium_tpu.testing import fixtures as jfix
from cilium_tpu_torch import convert, u32
from cilium_tpu_torch.datapath.loader import TorchLoader
from cilium_tpu_torch.monitor import ring as tring
from cilium_tpu_torch.testing import fixtures as tfix

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PROXY_PORTS = np.array([10000], np.uint32)


def _assert_rings_equal(tr_, jr_):
    got = tring.ring_drain(tr_, PROXY_PORTS)
    want = jring.ring_drain(jr_, PROXY_PORTS)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    return got


def test_torch_loader_matches_tpu_loader_through_the_slice():
    w = tfix.build_world(256, 8, ct_capacity=1 << 12, n_v6=16,
                         device="cpu")
    jw = jfix.build_world(256, 8, ct_capacity=1 << 12, n_v6=16)
    eps = {0: 0, 1: 0}
    tl = TorchLoader(ct_capacity=1 << 12, device="cpu")
    jl = TPULoader(ct_capacity=1 << 12)
    tl.attach(w.policies, w.ipcache, eps, w.row_map)
    jl.attach(jw.policies, jw.ipcache, eps, jw.row_map)
    tr_ = tring.EventRing.create(1 << 12, "cpu")
    jr_ = jring.EventRing.create(1 << 12)
    rng = np.random.default_rng(0)
    pool = tfix.steady_flow_pool(w, 256, rng)
    now = 100
    for b in range(4):  # the packed serving path, clock advancing
        hdr = pool if b == 0 else tfix.steady_traffic(pool, 512, rng)
        hdr = np.concatenate([hdr, tfix.bench_traffic(w, 512 - len(hdr),
                                                      rng)])
        packed = pack_rows(hdr)
        valid = rng.random(len(packed)) < 0.95
        tr_, _ = tl.serve_packed(tr_, packed, now, b, 0, b % 2,
                                 proxy_ports=PROXY_PORTS, valid=valid)
        jr_, _ = jl.serve_packed(jr_, packed, now, b, 0, b % 2,
                                 proxy_ports=jnp.asarray(PROXY_PORTS),
                                 valid=valid)
        now += 20
    wpool = tfix.wide_flow_pool(w, 256, rng)
    for b in range(4, 6):  # the wide path: v6 rows and ICMP errors
        hdr = tfix.wide_traffic(wpool, 512, rng)
        tr_, _ = tl.serve(tr_, hdr, now, b, proxy_ports=PROXY_PORTS)
        jr_, _ = jl.serve(jr_, hdr, now, b,
                          proxy_ports=jnp.asarray(PROXY_PORTS))
        now += 20
    rows, total, lost = _assert_rings_equal(tr_, jr_)
    assert total > 0 and lost == 0
    hdr = tfix.bench_traffic(w, 256, rng)
    tout, trm = tl.step(hdr, now)
    jout, jrm = jl.step(hdr, now)
    np.testing.assert_array_equal(tout, jout)
    assert trm is w.row_map
    np.testing.assert_array_equal(tl.metrics(), jl.metrics())
    np.testing.assert_array_equal(tl.ct_snapshot(), jl.ct_snapshot())
    assert tl.attach_count == 1 and tl.metrics().sum() > 0


def test_state_carried_across_mid_stream():
    """JAX serves the first batches; its state and ring cross over
    with convert.py, and both packages serve the rest.  The shapes and
    options are the loader test's, so JAX reuses its compiled step."""
    jw = jfix.build_world(256, 8, ct_capacity=1 << 12, n_v6=16)
    rng = np.random.default_rng(5)
    pool = jfix.steady_flow_pool(jw, 512, rng)
    js, jr_ = jw.state, jring.EventRing.create(1 << 12)
    z, pp = jnp.uint32(0), jnp.asarray(PROXY_PORTS)

    def jax_step(js, jr_, packed, b, valid):
        return jring.serve_step_packed_jit(
            js, jr_, jnp.asarray(packed), jnp.uint32(100 + b),
            jnp.uint32(b), z, z, trace_sample=1024,
            valid=jnp.asarray(valid), proxy_ports=pp, audit=False)

    for b in range(2):
        js, jr_ = jax_step(js, jr_, pack_rows(pool), b, np.ones(512, bool))
    arrays = {g: {f: (v if f == "default" else np.array(v))
                  for f, v in vars(getattr(js, g)).items()}
              for g in ("policy", "ipcache", "ct")}
    arrays["metrics"] = np.array(js.metrics)
    ts = convert.datapath_state_from_numpy(arrays, "cpu")
    tr_ = convert.event_ring_from_numpy(np.array(jr_.buf),
                                        np.array(jr_.cursor), "cpu")
    for b in range(2, 5):
        packed = pack_rows(jfix.steady_traffic(pool, 512, rng))
        valid = rng.random(512) < 0.95
        js, jr_ = jax_step(js, jr_, packed, b, valid)
        ts, tr_ = tring.serve_step_packed(
            ts, tr_, u32.from_numpy(packed, "cpu"), 100 + b, b, 0, 0,
            valid=torch.from_numpy(valid),
            proxy_ports=u32.from_numpy(PROXY_PORTS, "cpu"))
    _assert_rings_equal(tr_, jr_)
    back = convert.datapath_state_to_numpy(ts)
    np.testing.assert_array_equal(back["ct"]["table"], np.asarray(js.ct.table))
    np.testing.assert_array_equal(back["ct"]["fp"], np.asarray(js.ct.fp))
    np.testing.assert_array_equal(back["metrics"], np.asarray(js.metrics))


def _port_files():
    return sorted((ROOT / "cilium_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("chip_*.py"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "cilium_tpu"), (
                f"{path.name}:{node.lineno} imports {name}")


def test_port_import_leaves_jax_unloaded():
    # modules an interpreter start-up hook loaded before the import are
    # not the port's doing: judge only what the import adds
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import cilium_tpu_torch.datapath.loader, "
            "cilium_tpu_torch.monitor.ring, cilium_tpu_torch.convert, "
            "cilium_tpu_torch.testing.fixtures, cilium_tpu_torch.kernels, "
            "cilium_tpu_torch.agent.daemon, cilium_tpu_torch.serving, "
            "cilium_tpu_torch.serving.eventplane, "
            "cilium_tpu_torch.monitor.api, cilium_tpu_torch.monitor.agent, "
            "cilium_tpu_torch.datapath.pressure, cilium_tpu_torch.infra, "
            "cilium_tpu_torch.ipcache, cilium_tpu_torch.proxy, "
            "cilium_tpu_torch.serving.l7plane, cilium_tpu_torch.fqdn, "
            "cilium_tpu_torch.datapath.tables, "
            "cilium_tpu_torch.policy.incremental, "
            "cilium_tpu_torch.testing.workloads, "
            "cilium_tpu_torch.service.nat, "
            "cilium_tpu_torch.datapath.bandwidth, "
            "cilium_tpu_torch.testing.oracle, "
            "cilium_tpu_torch.testing.egress, "
            "cilium_tpu_torch.service, cilium_tpu_torch.service.socklb, "
            "cilium_tpu_torch.k8s.watchers, "
            "cilium_tpu_torch.testing.services, cilium_tpu_torch.ml, "
            "cilium_tpu_torch.ml.evaluate, cilium_tpu_torch.agent.auth, "
            "cilium_tpu_torch.k8s, cilium_tpu_torch.testing.connectivity\n"
            "bad = [m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'cilium_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


def _default_device_constructors():
    from cilium_tpu_torch.datapath.conntrack import CTTable
    from cilium_tpu_torch.datapath.lpm import DeviceLPM, compile_lpm
    from cilium_tpu_torch.datapath.verdict import DevicePolicy, build_state
    from cilium_tpu_torch.policy.compiler import (IdentityRowMap,
                                                  compile_policy)
    from cilium_tpu_torch.service import ServiceManager
    from cilium_tpu_torch.service.socklb import SockLBTable

    rm = IdentityRowMap(capacity=4)
    pt, lt = compile_policy([], rm), compile_lpm({"10.0.0.0/8": 0})
    buf, cursor = np.zeros((8, 2), np.uint32), np.zeros(2, np.uint32)
    return {
        "u32.from_numpy": lambda: u32.from_numpy(cursor),
        "CTTable.create": lambda: CTTable.create(1 << 4),
        "EventRing.create": lambda: tring.EventRing.create(1 << 4),
        "DeviceLPM.from_tensors": lambda: DeviceLPM.from_tensors(lt),
        "DevicePolicy.from_tensors": lambda: DevicePolicy.from_tensors(pt),
        "build_state": lambda: build_state(pt, lt, ct_capacity=1 << 4),
        "event_ring_from_numpy":
            lambda: convert.event_ring_from_numpy(buf, cursor),
        "ServiceManager.tensors": lambda: ServiceManager(m=7).tensors(),
        "SockLBTable.create": lambda: SockLBTable.create(1 << 4),
        "socklb_table_from_numpy": lambda: convert.socklb_table_from_numpy(
            np.zeros((4, 8), np.uint32), np.zeros(4, np.uint32),
            np.zeros((4, 8), np.uint32)),
        "datapath_state_from_numpy":
            lambda: convert.datapath_state_from_numpy(
                convert.datapath_state_to_numpy(
                    build_state(pt, lt, ct_capacity=1 << 4, device="cpu"))),
    }


@pytest.mark.parametrize("name", sorted(_default_device_constructors()))
def test_constructors_default_to_the_card(name):
    make = _default_device_constructors()[name]
    if torch.cuda.is_available():
        t = make()
        while not isinstance(t, torch.Tensor):  # first leaf of a state
            t = next(v for v in vars(t).values()
                     if isinstance(v, torch.Tensor)
                     or hasattr(v, "__dataclass_fields__"))
        assert t.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_the_card_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        assert TorchLoader(ct_capacity=1 << 8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchLoader(ct_capacity=1 << 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfix.build_world(16, 1, ct_capacity=1 << 8)
    # a tensor on a device with no kernel and no plain path raises
    from cilium_tpu_torch.datapath.lpm import DeviceLPM, compile_lpm, lpm_lookup

    lpm = DeviceLPM.from_tensors(compile_lpm({"10.0.0.0/8": 1}), "cpu")
    with pytest.raises(ValueError, match="no kernel"):
        lpm_lookup(lpm, torch.zeros((4, 4), dtype=torch.int32,
                                    device="meta"),
                   torch.zeros(4, dtype=torch.int32, device="meta"))
