"""The port's flow analytics plane (``cilium_tpu_torch/obs/analytics.py``)
against the JAX package's (``cilium_tpu/obs/analytics.py``) on the CPU.

The same seeded ``EventBatch`` streams (numpy columns, fixed timestamps,
so the window ids agree) go through both engines: ``snapshot()`` is equal
key for key, the batch ledger included.  The sketch, the spike detector
and the config validation are held against the reference alike.  At
daemon level the same port-scan batches go through the reference's
``process_batch`` and the port's ``Daemon(device="cpu")``, and
``flows_aggregate()`` gives the same verdict matrix, identity pairs and
talkers.  On the port's serving path (single, superbatch, sharded, and
with admission sheds) the aggregation never runs on the drain thread."""

import threading
import time

import numpy as np
import pytest

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.monitor.api import EventBatch as JEventBatch
from cilium_tpu.obs import analytics as jan
from cilium_tpu.testing import workloads as jwl
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT, COL_DST_IP3,
                                           COL_EP, COL_FAMILY, COL_FLAGS,
                                           COL_LEN, COL_PROTO, COL_SPORT,
                                           COL_SRC_IP3, N_COLS, TCP_SYN,
                                           ip_to_words)
from cilium_tpu_torch.monitor.api import (MSG_DROP, MSG_TRACE,
                                          EventBatch as TEventBatch)
from cilium_tpu_torch.obs import analytics as tan
from cilium_tpu_torch.testing import workloads as twl

CT = 1 << 12


def _columns(rng, n, ts, *, n_eps=4, n_ids=6, n_flows=48, drop_frac=0.3):
    """One seeded batch's columns: a few endpoints and remote identities,
    a flow pool small enough that talkers repeat, a share of drops and
    replies."""
    hdr = np.zeros((n, N_COLS), dtype=np.uint32)
    flow = rng.integers(0, n_flows, n)
    hdr[:, COL_SRC_IP3] = 0x0A000100 + (flow % 29)
    hdr[:, COL_DST_IP3] = 0x0A000200 + (flow % 7)
    hdr[:, COL_SPORT] = 1024 + flow
    hdr[:, COL_DPORT] = np.where(flow % 3 == 0, 443, 5432)
    hdr[:, COL_PROTO] = 6
    hdr[:, COL_LEN] = rng.integers(40, 1500, n)
    hdr[:, COL_FAMILY] = 4
    hdr[:, COL_EP] = 1 + rng.integers(0, n_eps, n)
    hdr[:, COL_DIR] = rng.integers(0, 2, n)
    drop = rng.random(n) < drop_frac
    return dict(
        msg_type=np.where(drop, MSG_DROP, MSG_TRACE).astype(np.uint8),
        verdict=np.where(drop, 0, 1).astype(np.uint8),
        reason=np.where(drop, rng.integers(1, 3, n), 0).astype(np.uint8),
        ct_state=rng.integers(0, 3, n).astype(np.uint8),
        identity=(100 + rng.integers(0, n_ids, n)).astype(np.uint32),
        proxy_port=np.zeros(n, dtype=np.uint16),
        hdr=hdr, timestamp=float(ts))


def _stream(seed, n_batches, *, t0=1000.0, dt=0.37, burst_at=None):
    """Seeded batch columns on a fixed clock; ``burst_at`` makes that
    batch a large all-drop burst (for the spike detector)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        n = int(rng.integers(16, 200))
        cols = _columns(rng, n, t0 + i * dt)
        if i == burst_at:
            cols = _columns(rng, 600, t0 + i * dt, drop_frac=1.0)
        out.append(cols)
    return out


def _strip(snap):
    """The wall-clock stamp of the last spike is the only field that
    differs between two runs of one stream."""
    spike = snap["spike"].get("last-spike")
    if spike is not None:
        snap["spike"]["last-spike"] = {k: v for k, v in spike.items()
                                       if k != "detected-at"}
    return snap


ENGINE_CASES = {
    "defaults": dict(seed=1, n=24, kw={}),
    "small-topk": dict(seed=2, n=24, kw=dict(topk=4, retention=3)),
    "spike": dict(seed=3, n=40, burst_at=30,
                  kw=dict(spike_min_drops=256, spike_baseline_windows=3)),
    "narrow-windows": dict(seed=4, n=32, kw=dict(window_s=0.25,
                                                 retention=16)),
    "queue-overflow": dict(seed=5, n=24, kw=dict(queue_depth=3),
                           drain_every=8),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_snapshot_equals_the_reference(case):
    c = ENGINE_CASES[case]
    kw = dict(max_duty=1.0, ep_identity=lambda e: 2000 + 3 * e)
    kw.update(c["kw"])
    fired = {"ref": [], "port": []}
    ref = jan.FlowAnalytics(
        on_incident=lambda k, d: fired["ref"].append((k, d["window"])),
        **kw)
    port = tan.FlowAnalytics(
        on_incident=lambda k, d: fired["port"].append((k, d["window"])),
        **kw)
    every = c.get("drain_every", 1)
    for i, cols in enumerate(_stream(c["seed"], c["n"],
                                     burst_at=c.get("burst_at"))):
        ref.submit(JEventBatch(**cols))
        port.submit(TEventBatch(**cols))
        if (i + 1) % every == 0:
            assert port.drain() == ref.drain()
    for top in (16, 3):
        want, got = _strip(ref.snapshot(top)), _strip(port.snapshot(top))
        assert list(got) == list(want)
        for key in want:
            assert got[key] == want[key], key
    led = port.stats()
    assert led["batches-submitted"] == (led["batches-ingested"]
                                        + led["batches-dropped"])
    assert led["pending"] == 0
    assert fired["port"] == fired["ref"]
    if case == "spike":
        assert [k for k, _ in fired["port"]] == ["drop-spike"]
    if case == "queue-overflow":
        assert led["batches-dropped"] > 0


def _big(seed, n):
    """One batch of ``n`` rows over few flows and identities, so that the
    top-K sketches hold every key exactly."""
    return _columns(np.random.default_rng(seed), n, 1000.0)


class _Clock:
    """A monotonic clock for the duty governor that moves only when a
    test moves it."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t

    @staticmethod
    def time():
        return time.time()


def test_a_capped_drain_ingests_a_large_batch_in_slices(monkeypatch):
    """Under a duty cap a batch past INGEST_SLICE rows is ingested a
    slice at a time; with the budget never spent (a clock that stands
    still) the snapshot equals the reference's whole-batch ingest."""
    n = 3 * tan.INGEST_SLICE + 5
    cols = _big(11, n)
    kw = dict(topk=64, ep_identity=lambda e: 2000 + 3 * e)
    ref = jan.FlowAnalytics(max_duty=1.0, **kw)
    ref.submit(JEventBatch(**cols))
    ref.drain()
    monkeypatch.setattr(tan, "time", _Clock())
    sizes = []
    real = tan.FlowAnalytics._ingest

    def spy(self, batch):
        sizes.append(len(batch))
        return real(self, batch)

    monkeypatch.setattr(tan.FlowAnalytics, "_ingest", spy)
    port = tan.FlowAnalytics(max_duty=0.5, **kw)
    port.submit(TEventBatch(**cols))
    assert port.drain() == 1
    assert sizes == [tan.INGEST_SLICE] * 3 + [5]
    want, got = ref.snapshot(16), port.snapshot(16)
    for key in want:
        assert got[key] == want[key], key


def test_the_duty_budget_cuts_a_large_batch_part_way(monkeypatch):
    """Each slice costs 0.06 s on the governor's clock: at a 0.1 s budget
    the third slice is not ingested, and the batch counts dropped."""
    clock = _Clock()
    monkeypatch.setattr(tan, "time", clock)
    real = tan.FlowAnalytics._ingest

    def costly(self, batch):
        clock.t += 0.06
        return real(self, batch)

    monkeypatch.setattr(tan.FlowAnalytics, "_ingest", costly)
    port = tan.FlowAnalytics(max_duty=0.1)
    port.submit(TEventBatch(**_big(12, 3 * tan.INGEST_SLICE)))
    port.drain()
    a = port.stats()
    assert a["packets-seen"] == 2 * tan.INGEST_SLICE
    assert (a["batches-submitted"], a["batches-ingested"],
            a["batches-dropped"]) == (1, 0, 1)
    assert port.ingest_failures == 0


def test_an_unreadable_batch_is_counted_and_logged(caplog):
    """A batch whose columns are not numpy (say, tensors left on the
    card) is a counted drop, an ingest failure and a logged warning."""
    torch = pytest.importorskip("torch")
    cols = _columns(np.random.default_rng(13), 64, 1000.0)
    bad = TEventBatch(**{k: torch.as_tensor(v.astype(np.int64))
                         if isinstance(v, np.ndarray) else v
                         for k, v in cols.items()})
    port = tan.FlowAnalytics(max_duty=1.0)
    port.submit(bad)
    port.submit(TEventBatch(**cols))
    with caplog.at_level("WARNING", logger=tan.__name__):
        port.drain()
    a = port.stats()
    assert (a["batches-ingested"], a["batches-dropped"]) == (1, 1)
    assert port.ingest_failures == 1
    assert any("could not ingest" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("k", [8, 64])
def test_sketch_equals_the_reference_on_a_zipf_stream(k):
    rng = np.random.default_rng(42 + k)
    draws = rng.zipf(1.5, size=30_000)
    draws = draws[draws < 100_000]
    n = len(draws)
    ref, port = jan.SpaceSavingSketch(k), tan.SpaceSavingSketch(k)
    for lo in range(0, n, 1000):
        keys, counts = np.unique(draws[lo:lo + 1000], return_counts=True)
        rows = np.stack([keys, keys % 7], axis=1).astype(np.int64)
        for sk in (ref, port):
            sk.update_batch(rows, counts.astype(np.int64),
                            (counts * 100).astype(np.int64))
    assert port.top() == ref.top()
    assert (port.total, port.evictions, port.error_bound()) == (
        ref.total, ref.evictions, ref.error_bound())
    # the documented guarantees hold on the port's own sketch
    exact = dict(zip(*np.unique(draws, return_counts=True)))
    bound = n // k
    kept = {r["key"][0]: r for r in port.top()}
    for key, cnt in exact.items():
        if cnt > bound:
            assert key in kept, f"elephant {key} evicted"
    for key, r in kept.items():
        assert exact[key] <= r["packets"] <= exact[key] + bound
        assert r["packets"] - r["error"] <= exact[key]
    # the one-key path agrees too
    for sk in (ref, port):
        for i in range(12):
            sk.update((i, 0), i + 1, 10 * (i + 1))
    assert port.top() == ref.top()


def _observe(mod, seq):
    det = mod.SpikeDetector(4.0, 64, 4)
    fired = []
    for i, drops in enumerate(seq):
        w = mod._Window(i, 1.0)
        w.drops = int(drops)
        w.packets = int(drops) + 1000
        got = det.observe(w)
        if got is not None:
            fired.append({k: v for k, v in got.items()
                          if k != "detected-at"})
    return det, fired


@pytest.mark.parametrize("schedule", ["one-burst", "two-bursts"])
def test_spike_detector_equals_the_reference(schedule):
    rng = np.random.default_rng(7)
    quiet = list(rng.poisson(5.0, size=12))
    if schedule == "one-burst":
        # three consecutive burst windows: ONE incident, no flapping
        seq = quiet + list(rng.integers(400, 600, size=3)) + list(
            rng.poisson(5.0, size=8))
    else:
        # a second burst after the release fires again
        seq = quiet[:4] + [500, 5, 5, 600, 4]
    (rd, rf), (pd, pf) = _observe(jan, seq), _observe(tan, seq)
    assert pf == rf
    assert (pd.spikes, pd.in_spike, pd.baseline) == (
        rd.spikes, rd.in_spike, rd.baseline)
    assert pd.spikes == (1 if schedule == "one-burst" else 2)
    assert pd.baseline < 64  # the burst never entered the baseline
    assert not pd.in_spike


BAD_KNOBS = {
    "window_s": (0, 8, 32, 16, 4.0, 64, 4, 0.1),
    "windows": (1.0, 0, 32, 16, 4.0, 64, 4, 0.1),
    "topk": (1.0, 8, 0, 16, 4.0, 64, 4, 0.1),
    "queue_depth": (1.0, 8, 32, 0, 4.0, 64, 4, 0.1),
    "spike_factor": (1.0, 8, 32, 16, 0.5, 64, 4, 0.1),
    "spike_min_drops": (1.0, 8, 32, 16, 4.0, 0, 4, 0.1),
    "spike_baseline_windows": (1.0, 8, 32, 16, 4.0, 64, 0, 0.1),
    "max_duty": (1.0, 8, 32, 16, 4.0, 64, 4, 1.5),
}


@pytest.mark.parametrize("knob", sorted(BAD_KNOBS))
def test_config_validation_equals_the_reference(knob):
    args = BAD_KNOBS[knob]
    with pytest.raises(ValueError) as want:
        jan.validate_analytics_config(*args)
    with pytest.raises(ValueError) as got:
        tan.validate_analytics_config(*args)
    assert str(got.value) == str(want.value)
    ok = (2, "3", 4.0, 5, "6.0", 7.0, 8, "0.5")
    assert tan.validate_analytics_config(*ok) == \
        jan.validate_analytics_config(*ok)


# -- at daemon level ------------------------------------------------------


def test_flows_aggregate_equals_the_reference_on_port_scan():
    """The same port-scan batches through the reference's process_batch
    and the port's: the same verdict matrix, identity pairs and talkers
    (one-hour windows, so the two runs share their window)."""
    over = dict(ct_capacity=CT, flow_agg_window_s=3600.0,
                flow_agg_max_duty=1.0, map_pressure_interval=0.0,
                history_interval=0.0)
    sc = [mod.make_scenario("port_scan", seed=19, n_packets=1024,
                            batch=256) for mod in (jwl, twl)]
    jd = JDaemon(JConfig(backend="tpu", **over))
    td = Daemon(DaemonConfig(**over), device="cpu")
    jd._now = td._now = lambda: 7
    ctx = [s.setup(d) for s, d in zip(sc, (jd, td))]
    assert ctx[0] == ctx[1]
    for b in sc[1].iter_batches(ctx[1]["ep"]):
        jd.process_batch(b)
        td.process_batch(b)
    want, got = jd.flows_aggregate(), td.flows_aggregate()
    for key in ("matrix", "top-identity-pairs", "top-talkers",
                "sketch-error-bound", "evictions", "top-k"):
        assert got[key] == want[key], key
    assert got["ledger"] == want["ledger"]
    assert got["ledger"]["batches-ingested"] == 4
    assert got["ledger"]["packets-seen"] == 1024
    assert got["matrix"][0]["reason"] == 2  # the sweep default-denies
    assert td.status()["flow-aggregation"] == jd.status()[
        "flow-aggregation"]
    for d in (jd, td):
        d.shutdown()


# -- never on the drain thread ---------------------------------------------

RULES = [{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [{
        "fromEndpoints": [{"matchLabels": {"app": "web"}}],
        "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}],
    }],
}]


def _daemon(**over):
    cfg = dict(ct_capacity=CT, flow_ring_capacity=1 << 13,
               serving_queue_depth=4096, serving_bucket_ladder=(64,),
               serving_max_wait_us=500.0, flow_agg_window_s=0.2,
               map_pressure_interval=0.0)
    cfg.update(over)
    d = Daemon(DaemonConfig(**cfg), device="cpu")
    d.add_endpoint("web", ("10.0.1.1",), ["k8s:app=web"])
    db = d.add_endpoint("db", ("10.0.2.1",), ["k8s:app=db"])
    d.policy_import(RULES)
    return d, db


def _fwd(db_id, n=64, base=20000, dport=5432):
    rows = np.zeros((n, N_COLS), dtype=np.uint32)
    rows[:, COL_SRC_IP3] = ip_to_words("10.0.1.1")[3]
    rows[:, COL_DST_IP3] = ip_to_words("10.0.2.1")[3]
    rows[:, COL_SPORT] = base + np.arange(n)
    rows[:, COL_DPORT] = dport
    rows[:, COL_PROTO] = 6
    rows[:, COL_FLAGS] = TCP_SYN
    rows[:, COL_LEN] = 60
    rows[:, COL_FAMILY] = 4
    rows[:, COL_EP] = db_id
    rows[:, COL_DIR] = 0
    return rows


def _wait(pred, timeout=30.0, tick=0.002):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(tick)
    return True


SERVING_MODES = {
    "single": ({}, {}),
    "superbatch": ({}, {"superbatch_k": 4}),
    "sharded": ({}, {"mesh": 2, "packed": False}),
    # a chunk past the queue depth: the drain thread publishes the
    # shed rows as host-made DROP batches
    "sheds": ({"serving_queue_depth": 128}, {}),
}


@pytest.mark.parametrize("mode", sorted(SERVING_MODES))
def test_ingest_runs_only_off_the_drain_thread(mode, monkeypatch):
    seen = []
    real = tan.FlowAnalytics._ingest

    def spy(self, batch):
        seen.append(threading.current_thread().name)
        return real(self, batch)

    monkeypatch.setattr(tan.FlowAnalytics, "_ingest", spy)
    cfg, serving = SERVING_MODES[mode]
    d, db = _daemon(**cfg)
    d.start_serving(trace_sample=1, ingress=True, drain_every=2,
                    **serving)
    rt = d._serving["runtime"]
    if mode == "sheds":
        d.submit(np.concatenate([_fwd(db.id, base=20000 + 100 * i)
                                 for i in range(4)]))
    else:
        for i in range(4):
            d.submit(_fwd(db.id, base=20000 + 100 * i))
        assert _wait(lambda: rt.stats.verdicts >= 256)
        assert _wait(lambda: d.analytics.packets_seen >= 256)
    out = d.stop_serving()
    fe = out["front-end"]
    assert fe["submitted"] == 256 == (
        fe["verdicts"] + fe["shed"]
        + fe["fault-tolerance"]["recovery-dropped"])
    if mode == "sheds":
        assert fe["shed"] > 0
    assert seen, "aggregation never ran"
    drain = [n for n in seen if n.startswith("serving-drain")]
    assert not drain, f"aggregation ran on the drain thread: {drain}"
    if mode != "sheds":
        assert any(n.startswith("serving-eventjoin") for n in seen)
    a = d.analytics.stats()
    assert a["batches-submitted"] == (a["batches-ingested"]
                                      + a["batches-dropped"])
    assert a["pending"] == 0
    # every published event reached the engine (a batch it could not
    # read would count as dropped)
    assert a["batches-dropped"] == 0
    assert a["packets-seen"] == d.monitor.published == 256
    d.shutdown()


def test_serving_surfaces_and_the_roll_controller():
    """The daemon's surfaces: ``serving_stats()["analytics"]``,
    ``status()["flow-aggregation"]``, ``flows_aggregate``, the
    ``flow-agg-roll`` controller from ``start()``, and a drop burst
    followed by silence recorded as a ``drop-spike`` incident."""
    d, db = _daemon(flow_agg_window_s=0.1, spike_min_drops=32)
    d.start()
    assert d.controllers.get("flow-agg-roll") is not None
    d.start_serving(trace_sample=1, ingress=True, drain_every=2)
    # SYNs to a closed port: every row drops (default deny)
    d.submit(_fwd(db.id, n=64, base=30000, dport=9999))
    assert _wait(lambda: d.serving_stats()["analytics"]["packets-seen"]
                 >= 64)
    assert _wait(lambda: any(i["kind"] == "drop-spike"
                             for i in d.incidents), timeout=10.0)
    spike = [i for i in d.incidents if i["kind"] == "drop-spike"][0]
    assert spike["detail"]["drops"] == 64
    d.stop_serving()
    agg = d.flows_aggregate(top=4)
    assert agg["spike"]["spikes"] == 1
    assert agg["top-identity-pairs"][0]["packets"] == 64
    assert d.status()["flow-aggregation"]["spikes"] == 1
    d.shutdown()


def test_an_analytics_fault_at_the_window_join_drops_no_window(
        monkeypatch):
    """The event join's drain is contained: a failing aggregation is
    logged, and the window's events still count as delivered."""
    d, db = _daemon()

    def boom():
        raise RuntimeError("analytics fault")

    monkeypatch.setattr(d.analytics, "drain", boom)
    d.start_serving(trace_sample=1, ingress=True, drain_every=2)
    for i in range(2):
        d.submit(_fwd(db.id, base=21000 + 100 * i))
    assert _wait(lambda: d.serving_stats()["verdicts"] >= 128)
    monkeypatch.undo()
    out = d.stop_serving()
    ev = out["event-plane"]
    assert ev["windows-dropped"] == 0 and out["lost"] == 0
    assert out["events"] == 128 == d.monitor.published
    d.shutdown()


def test_the_event_join_drains_analytics_only_with_no_window_waiting(
        monkeypatch):
    """The event-join worker leaves the analytics pending while windows
    wait behind the one it joined: the first join holds until later
    windows queue, so fewer joins drain than windows are joined, and
    every event still reaches the engine."""
    d, db = _daemon(serving_window_queue_depth=16)
    drains = []
    real_drain = d.analytics.drain

    def drain():
        if threading.current_thread().name.startswith("serving-eventjoin"):
            drains.append(1)
        return real_drain()

    monkeypatch.setattr(d.analytics, "drain", drain)
    real_emit = d._emit_ring_rows
    held = []

    def emit(*args):
        if not held:
            held.append(_wait(lambda: d._serving["eventplane"].pending > 1,
                              timeout=30.0))
        return real_emit(*args)

    monkeypatch.setattr(d, "_emit_ring_rows", emit)
    d.start_serving(trace_sample=1, ingress=True, drain_every=1)
    for i in range(8):
        d.submit(_fwd(db.id, base=22000 + 100 * i))
    assert _wait(lambda: d.serving_stats()["verdicts"] >= 512)
    out = d.stop_serving()
    ev = out["event-plane"]
    assert held == [True], "no window waited behind the first"
    assert ev["windows-dropped"] == 0 and out["events"] == 512
    assert len(drains) < ev["windows-joined"]
    a = d.analytics.stats()
    assert a["packets-seen"] == 512 and a["batches-dropped"] == 0
    assert a["pending"] == 0
    d.shutdown()


def test_analytics_off_parks_nothing():
    d, db = _daemon(flow_agg_enabled=False)
    d.start()
    assert d.controllers.get("flow-agg-roll") is None
    d.process_batch(_fwd(db.id), now=5)
    st = d.status()["flow-aggregation"]
    assert st["enabled"] is False and st["batches-submitted"] == 0
    d.shutdown()
