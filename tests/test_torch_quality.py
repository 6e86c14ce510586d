"""The port's quality observatory (server/quality.py) held against the
JAX package's: the scenarios of tests/test_quality.py (its HTTP surfaces
are left out with the port's HTTP), with both Servers on one world.

  * the delta-kept placement accounting under churn (register,
    deregister, the client's acknowledgements, a new job) equals a
    recount over the store and the store's own fold, and its report
    equals the reference's;
  * a delta-less alloc write marks the accounting for a rebuild;
  * the shadow audit is deterministic and clean, and audits the eval ids
    the reference audits; ``_replay_lane`` gives the reference's choices
    and scores on the same lanes;
  * the ``quality.skew`` drill latches the alert;
  * each kill switch, and all three together, leave placements, scores
    and store writes as they are with everything on;
  * the saturation tracker sees every pipeline stage.

Each test resets both packages' globals; every wait has a deadline."""
import time

import numpy as np
import pytest

from nomad_tpu.server import quality as ref_quality
from nomad_tpu.server.quality import observatory as ref_obs

from nomad_tpu_torch.faultinject import faults
from nomad_tpu_torch.server import quality
from nomad_tpu_torch.server.quality import observatory
from nomad_tpu_torch.server.telemetry import metrics
from nomad_tpu_torch.server.tracing import tracer

from test_torch_client_ack import (
    ack_pair, acks, deregister, each, register, store_digest)
from test_torch_server import (  # noqa: F401
    fresh_state, run_servers, server_digest)
from test_torch_scheduler import tier_world
from test_torch_telemetry import reset_globals


@pytest.fixture(autouse=True)
def quality_env(monkeypatch):
    """Audit every solved eval in both packages (the hash sampler has
    its own test), from clean globals."""
    for prefix in ("NOMAD_TPU_", "NOMAD_TPU_TORCH_"):
        monkeypatch.setenv(prefix + "QUALITY_AUDIT_SAMPLE", "1.0")
    reset_globals()
    yield
    faults._reset_for_tests()
    reset_globals()


def _report(obs, store):
    rep = obs.placement.report(store)
    rep.pop("since_s")
    rep["churn"].pop("per_s")
    return rep


def churn(ref, port):
    """Three jobs placed; the first deregistered and its stops
    acknowledged complete; a fourth placed."""
    for i in range(3):
        register(ref, port, f"q-churn-{i}", 8, 70 + i, cpu=100, mem=64)
    deregister(ref, port, "q-churn-0", 80)
    for server, _, _ in each(ref, port):
        server.update_allocs_from_client(
            acks(server, "q-churn-0", "complete",
                 pick=lambda a: a.desired_status != "run"))
    register(ref, port, "q-churn-new", 8, 81, cpu=100, mem=64)


def test_placement_accounting_under_churn_equals_the_reference():
    with ack_pair(n_nodes=6, cpu=8000, mem=16384) as (ref, port):
        churn(ref, port)
        assert store_digest(port) == store_digest(ref)
        acct = observatory.placement
        c = dict(acct._churn)
        assert c["placements"] >= 32 and c["stops"] >= 8
        assert c["completions"] >= 8
        # the delta-kept accounting against the store's recount, before
        # the parity pass replaces it
        with acct._lock:
            mine = {nid: tuple(v[:3]) for nid, v in acct._used.items()
                    if any(abs(x) > 1e-9 for x in v[:3])}
        table = {nid: v for nid, v in
                 port.state.quality_usage_by_node().items()
                 if any(abs(x) > 1e-9 for x in v)}
        assert set(mine) == set(table)
        for nid in mine:
            assert mine[nid] == pytest.approx(table[nid], abs=1e-6)
        got = _report(observatory, port.state)
        want = _report(ref_obs, ref.state)
        assert got == want
        assert observatory.parity_mismatch() == 0
        assert ref_obs.parity_mismatch() == 0
        assert got["attached"] and 0.0 <= got["fragmentation_index"] <= 1.0
        assert sum(got["utilization"]["cpu"]["hist"]) == \
            got["fleet"]["nodes"]
        assert got["fleet"]["live_allocs"] == len(
            [a for a in port.state.allocs()
             if not a.client_terminal_status()])


def test_accounting_survives_structured_delta_gaps():
    with ack_pair(n_nodes=3) as (ref, port):
        register(ref, port, "q-gap", 4, 90)
        for server, obs in ((ref, ref_obs), (port, observatory)):
            with server.state._lock:
                server.state._bump("allocs")      # a delta-less write
            assert obs.placement._needs_rebuild
        rep = observatory.placement.report(port.state)
        assert rep["fleet"]["live_allocs"] == 4
        assert not observatory.placement._needs_rebuild
        assert observatory.parity_mismatch() == 0
        assert _report(observatory, port.state) == \
            _report(ref_obs, ref.state)


def _audited_world(seed=0):
    with ack_pair(n_nodes=5, num_workers=1) as (ref, port):
        register(ref, port, "q-audit", 12, 91 + seed, cpu=300, mem=128)
        assert observatory.audit.wait_idle(timeout=30.0)
        assert ref_obs.audit.wait_idle(timeout=30.0)
        return (observatory.audit.results(), observatory.audit.report(),
                ref_obs.audit.results(), store_digest(port))


def test_shadow_audit_is_clean_deterministic_and_the_references():
    res1, rep1, ref_res, placed1 = _audited_world()
    assert rep1["audited"] >= 1, rep1
    assert rep1["decision_mismatch_total"] == 0, rep1
    assert rep1["score_drift_max"] <= 1e-6, rep1
    assert rep1["alert"] is None
    # the same eval ids audited as the reference, with its verdicts
    assert set(res1) == set(ref_res)
    for eid, r in res1.items():
        assert r["decision_mismatches"] == 0
        assert r["places"] == ref_res[eid]["places"]
    reset_globals()
    res2, rep2, _, placed2 = _audited_world()
    assert set(res2) == set(res1) and placed2 == placed1
    for eid in res1:
        assert res2[eid]["score_drift"] == res1[eid]["score_drift"]
        assert res2[eid]["decision_mismatches"] == \
            res1[eid]["decision_mismatches"]


def test_audit_sampling_is_the_references_hash(monkeypatch):
    for prefix in ("NOMAD_TPU_", "NOMAD_TPU_TORCH_"):
        monkeypatch.setenv(prefix + "QUALITY_AUDIT_SAMPLE", "0.5")
    ids = [f"eval-{i}" for i in range(200)]
    wants = [observatory.audit.wants(i) for i in ids]
    assert wants == [ref_obs.audit.wants(i) for i in ids]
    assert 40 < sum(wants) < 160
    monkeypatch.setenv("NOMAD_TPU_TORCH_QUALITY_AUDIT_SAMPLE", "0")
    assert not observatory.audit.wants("eval-0")


def _items(rng, n_items=12):
    """Seeded simple lanes for both packages' _AuditItem."""
    out = []
    for k in range(n_items):
        n = int(rng.integers(3, 40))
        cap = rng.choice([1000.0, 2000.0, 4000.0], n)
        fields = dict(
            eval_id=f"replay-{k}", job_id="j", tg_name="web",
            node_ids=tuple(f"n{i}" for i in range(n)),
            order=rng.permutation(n).astype(np.int64),
            cpu_cap=cap, mem_cap=cap * 2, disk_cap=np.full(n, 1e5),
            feasible=rng.random(n) > 0.15,
            used_cpu=np.floor(rng.random(n) * cap * 0.8),
            used_mem=np.floor(rng.random(n) * cap),
            used_disk=np.zeros(n),
            placed=rng.integers(0, 2, n).astype(np.float64),
            ask_cpu=float(rng.choice([100.0, 250.0, 500.0])),
            ask_mem=float(rng.choice([64.0, 256.0])), ask_disk=0.0,
            count=int(rng.integers(1, 12)),
            limit=int(rng.integers(1, 8)),
            spread_alg=bool(k % 3 == 0))
        fields["chosen"] = np.full(int(rng.integers(1, 16)), -1,
                                   dtype=np.int64)
        fields["scores"] = np.zeros(fields["chosen"].shape[0])
        out.append(fields)
    return out


def _item(mod, fields):
    it = mod._AuditItem()
    for k, v in fields.items():
        setattr(it, k, v)
    return it


def test_replay_lane_is_the_references_on_the_same_lanes():
    assert (quality.BINPACK_MAX, quality.MAX_SKIP,
            quality.SKIP_THRESHOLD) == (18.0, 3, 0.0)
    for fields in _items(np.random.default_rng(7)):
        want_c, want_s = ref_quality._replay_lane(_item(ref_quality,
                                                        fields))
        got_c, got_s = quality._replay_lane(_item(quality, fields))
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_array_equal(got_s, want_s)
        fields = dict(fields, chosen=got_c)
        f_want = ref_quality._replay_lane(_item(ref_quality, fields),
                                          follow=got_c)
        f_got = quality._replay_lane(_item(quality, fields), follow=got_c)
        for x, y in zip(f_got, f_want):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(f_got[1][got_c >= 0],
                                      got_s[got_c >= 0])


def test_replay_lane_mirrors_kernel_semantics():
    fields = dict(
        eval_id="unit", job_id="unit", tg_name="web",
        node_ids=("n0", "n1", "n2"), order=np.arange(3, dtype=np.int64),
        cpu_cap=np.full(3, 1000.0), mem_cap=np.full(3, 1000.0),
        disk_cap=np.full(3, 1000.0),
        feasible=np.array([True, True, False]),
        used_cpu=np.array([0.0, 500.0, 0.0]),
        used_mem=np.array([0.0, 500.0, 0.0]), used_disk=np.zeros(3),
        placed=np.zeros(3), ask_cpu=100.0, ask_mem=100.0, ask_disk=0.0,
        count=2, limit=2, spread_alg=False,
        chosen=np.array([1, 0], dtype=np.int64), scores=np.zeros(2))
    chosen, scores = quality._replay_lane(_item(quality, fields))
    # best fit: the half-full node 1 wins place 0; its anti-affinity
    # then hands place 1 to the empty node 0
    assert chosen.tolist() == [1, 0] and scores[0] > 0
    follow, fscores = quality._replay_lane(_item(quality, fields),
                                           follow=fields["chosen"])
    assert follow.tolist() == [1, 0]
    assert fscores[0] == pytest.approx(scores[0])


def test_skew_drill_latches_the_alert(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_QUALITY_ALERT_AFTER", "1")
    faults.arm("quality.skew", "error")
    with ack_pair(n_nodes=5) as (ref, port):
        register(ref, port, "q-skew", 12, 92, cpu=300, mem=128)
        assert observatory.audit.wait_idle(timeout=30.0)
    rep = observatory.audit.report()
    assert rep["audited"] >= 1
    assert rep["score_drift_max"] > 0.2, rep
    assert rep["alert"] is not None and \
        rep["alert"]["reason"] == "score_drift"
    snap = metrics.snapshot()
    assert snap["counters"].get("nomad.quality.audit_alert", 0) >= 1
    assert snap["gauges"]["nomad.quality.score_drift"]["max"] > 0.2


KILL_SWITCHES = [("NOMAD_TPU_TORCH_QUALITY",),
                 ("NOMAD_TPU_TORCH_TRACE", "NOMAD_TPU_TORCH_XFEROBS",
                  "NOMAD_TPU_TORCH_QUALITY")]


@pytest.mark.parametrize("switches", KILL_SWITCHES,
                         ids=["quality", "all-three"])
def test_kill_switches_leave_the_port_bit_for_bit(switches, monkeypatch):
    """With the switches off, the port's Server commits the same allocs
    (scores to the bit), evals and store writes as with all on; the
    store hook is never installed and the layers report off."""
    def run():
        store, ev, _ = tier_world(2, 40, 30, 1, "tpu-binpack")
        _, port = run_servers(store, [ev])
        digest, scores = server_digest(port)
        return digest, scores, store_digest(port), \
            port.state._quality_hook, port.state.latest_index()

    on = run()
    reset_globals()
    for name in switches:
        monkeypatch.setenv(name, "0")
    off = run()
    assert off[0] == on[0] and off[2] == on[2] and off[4] == on[4]
    assert [s for _, s in off[1]] == [s for _, s in on[1]]
    assert on[3] is None and off[3] is None       # detached at shutdown
    assert observatory.report() == {"enabled": False}
    assert observatory.bench_fields() == {"quality_enabled": False}
    if len(switches) == 3:
        assert tracer.stats()["retained"] == 0
        from nomad_tpu_torch.solver import xferobs
        assert xferobs.state() == {"enabled": False}


def test_saturation_sees_every_pipeline_stage(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_TRACE_SAMPLE", "0")
    store, ev, _ = tier_world(2, 40, 30, 1, "tpu-binpack")
    run_servers(store, [ev])
    rep = observatory.saturation.report()
    stages = rep["stages"]
    for stage, kind in (("broker.wait", "wait"), ("worker.wait", "wait"),
                        ("worker", "busy"), ("pack", "busy"),
                        ("dispatch", "busy"), ("dispatch.wait", "wait"),
                        ("commit", "busy"), ("commit.wait", "wait")):
        assert stage in stages, (stage, sorted(stages))
        assert stages[stage]["kind"] == kind and stages[stage]["count"] >= 1
    assert rep["bottleneck"] in stages
    assert sum(d["share_of_recorded_pct"] for d in stages.values()) == \
        pytest.approx(100.0, abs=1.0)
    fields = observatory.bench_fields()
    assert fields["quality_enabled"]
    assert "quality_drift" in fields
    assert any(k.startswith("stage_busy_pct_") for k in fields)


def test_attach_detach_follow_the_server():
    with ack_pair(n_nodes=2) as (ref, port):
        assert observatory.active and port.state._quality_hook is not None
        t0 = time.time()
        rep = observatory.report()
        assert rep["enabled"] and rep["attached"]
        assert time.time() - t0 < 10
    assert not observatory.active
    assert port.state._quality_hook is None
