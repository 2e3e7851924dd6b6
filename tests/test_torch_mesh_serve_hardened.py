"""Hardened serving under a (2, 2) mesh: four gloo ranks on the CPU,
smollm-135m-smoke with 4 slots (2 a data rank), page 4, chunk 4, int8
weights and KV, against the reference's one-device scheduler.

Audited runs (``Scheduler(audit=True)``, the steps' ``with_health=``) of
dense ``chunked``, paged ``chunked`` and paged ``ragged`` run clean and
stream what the unaudited runs and the reference stream; the health flags
ride the tick's one host-read gather, and each tick's verdict is agreed in
one all-reduce over ``data``.  A fault plan (``alloc_fail``, ``swap_fail``
and a NaN on slot 2, data rank 1's) fails its victim alone on every rank,
with the reference's statuses and ``fault_events``; at temperature 0.7 it
equals the port's one device.  A page-table breach on data rank 1's block
raises on every rank at the end of its own tick, so no rank is left in a
collective the others never reach.
"""
import numpy as np
import pytest

from _torch_dist_ranks import (AUDIT_CASES, BREACH_TICK, COUNTERS, FAULT_CASE, MESH_SLOTS,
                               launch)
from test_torch_mesh_serve_pool import WORKLOADS, reference_counters, reference_runs

RANKS = range(4)
CASES = {**{f"audit/{n}": ("base", True, e, {**s, "audit": True}, {})
            for n, (e, s) in AUDIT_CASES.items()},
         "fault": ("base", True) + FAULT_CASE}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref, inputs, d = reference_runs(tmp_path_factory, "mesh_hardened", CASES,
                                    {"base": WORKLOADS["base"]})
    return ref, launch(4, "mesh_hardened", inputs, d)


def _counter(r, key, name):
    return r[f"{key}/counters"][COUNTERS.index(name)]


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("case", list(AUDIT_CASES))
def test_audited_streams_equal_the_unaudited_and_the_reference(runs, case, rank):
    ref, ranks = runs
    r = ranks[rank]
    np.testing.assert_array_equal(r[f"{case}/audit/streams"], r[f"{case}/plain/streams"])
    np.testing.assert_array_equal(r[f"{case}/audit/streams"][:, :-1],
                                  ref[f"audit/{case}/tokens"])
    assert (r[f"{case}/audit/streams"][:, -1] == 0).all()
    assert (ref[f"audit/{case}/status"] == "ok").all()


@pytest.mark.parametrize("case", list(AUDIT_CASES))
def test_audits_run_clean_every_tick_on_every_rank(runs, case):
    """Every tick is audited clean; a paged tick reads the flags and then
    the table and lens back (two copies), a dense tick the flags."""
    ref, ranks = runs
    for r in ranks:
        ticks = _counter(r, f"{case}/audit", "decode_steps")
        assert _counter(r, f"{case}/audit", "audited_ticks") == ticks
        assert _counter(r, f"{case}/audit", "audit_reads") == ticks * (1 if case == "dense"
                                                                       else 2)
        np.testing.assert_array_equal(r[f"{case}/audit/counters"],
                                      ranks[0][f"{case}/audit/counters"])
    want = reference_counters(ref, f"audit/{case}")
    assert want["audited_ticks"] == _counter(ranks[0], f"{case}/audit", "audited_ticks")


@pytest.mark.parametrize("case", list(AUDIT_CASES))
def test_audit_adds_no_gather_and_one_verdict_a_tick(runs, case):
    """The health flags travel in the tick's one host-read gather: the
    audited run gathers as often as the unaudited one, and agrees its
    verdict in one all-reduce over ``data`` a tick."""
    _, ranks = runs
    for r in ranks:
        ticks = _counter(r, f"{case}/audit", "decode_steps")
        assert _counter(r, f"{case}/plain", "decode_steps") == ticks
        for mode in ("audit", "plain"):
            assert r[f"{case}/{mode}/calls/data/host"][0] == ticks
        assert r[f"{case}/audit/calls/data/audit"][0] == ticks
        assert f"{case}/plain/calls/data/audit" not in r


@pytest.mark.parametrize("rank", RANKS)
def test_fault_plan_fails_its_victim_alone_as_the_reference(runs, rank):
    from repro_torch.serve.scheduler import STATUSES

    ref, ranks = runs
    got = ranks[rank]["fault/streams"]
    np.testing.assert_array_equal(got[:, :-1], ref["fault/tokens"])
    statuses = [STATUSES[s] for s in got[:, -1]]
    assert statuses == list(ref["fault/status"])
    assert statuses == ["ok", "ok", "failed", "ok", "ok", "ok"]
    want = reference_counters(ref, "fault")
    for name in ("fault_events", "nan_evictions", "swap_refusals", "failed"):
        assert _counter(ranks[rank], "fault", name) == want[name], name
    assert want["fault_events"] == 3 and want["swap_refusals"] == 1


def test_fault_plan_counts_alike_on_every_rank(runs):
    _, ranks = runs
    for key in ("fault", "sampled/mesh"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{key}/counters"], ranks[0][f"{key}/counters"])


@pytest.mark.parametrize("rank", RANKS)
def test_sampled_fault_plan_equals_the_ports_one_device(runs, rank):
    """At temperature 0.7 every rank samples the gathered rows with one
    generator: the streams, statuses and counters of the port's one device
    (its cache bytes are a rank's)."""
    r = runs[1][rank]
    np.testing.assert_array_equal(r["sampled/mesh/streams"], r["sampled/one/streams"])
    mesh, one = r["sampled/mesh/counters"], r["sampled/one/counters"]
    keep = [i for i, k in enumerate(COUNTERS) if k != "peak_cache_bytes"]
    np.testing.assert_array_equal(mesh[keep], one[keep])
    assert (r["sampled/mesh/streams"][:, -1] != 0).sum() == 1


def test_a_breach_on_one_rank_raises_on_every_rank_in_its_own_tick(runs):
    """Data rank 1's step corrupts its live slot's table row at the breach
    tick: its ranks raise the breach, data rank 0's that rank 1 failed, all
    at the end of that tick; the launch ends (no rank waits in a
    collective)."""
    _, ranks = runs
    per_rank = MESH_SLOTS // 2
    for r in ranks:
        assert bool(r["breach/corrupted"]) == (int(r["data_rank"]) == 1)
        assert int(r["breach/tick"]) == BREACH_TICK
        msg = str(r["breach/message"])
        if int(r["data_rank"]) == 1:
            slot = int(msg.split(":")[0].split()[1])
            assert msg.startswith(f"slot {slot}: device table row") and slot // per_rank == 1
        else:
            assert msg == f"tick {BREACH_TICK}: the audit failed on data rank(s) [1] (each " \
                          f"raises its own breach)"
