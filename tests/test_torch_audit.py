"""Port parity for the invariant auditor: the property tests of
``tests/test_paging_properties.py`` (honest churn passes, every injected
corruption is caught) run the same hypothesis-drawn states through the
port's ``serve/audit.py`` and repro's.  Both must pass, or both must raise
``AuditError`` with the same message."""
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve import audit as j_audit
from repro.serve.paging import PageAllocator as JPageAllocator
from repro.serve.paging import SwapArea as JSwapArea
from repro_torch.serve import audit as t_audit
from repro_torch.serve.paging import PageAllocator, SwapArea

POOL = 12

ops_strategy = st.lists(
    st.tuples(st.sampled_from(["alloc", "share", "free"]), st.integers(0, 10)),
    max_size=250)


def verdict(audit, fn, *args, **kw):
    """None when ``fn`` passes, else its AuditError's message."""
    try:
        getattr(audit, fn)(*args, **kw)
    except audit.AuditError as e:
        return str(e)
    return None


def same(fn, t_args, j_args, t_kw=None, j_kw=None):
    """Both auditors' verdicts on the same state: equal; returns it."""
    got = verdict(t_audit, fn, *t_args, **(t_kw or {}))
    want = verdict(j_audit, fn, *j_args, **(j_kw or {}))
    assert got == want
    return got


def _churn(a, ops):
    """``test_paging_properties._churn``: alloc/share/free churn; the live
    holder map the scheduler would give ``check_allocator``."""
    held = {}
    nxt = 0
    for op, arg in ops:
        if op == "alloc":
            got = a.alloc(arg % 5)
            if got is not None:
                held[("slot", nxt)] = list(got)
                nxt += 1
        elif op == "share" and held:
            key = sorted(held)[arg % len(held)]
            a.share(held[key])
            held[("parked", nxt)] = list(held[key])
            nxt += 1
        elif op == "free" and held:
            key = sorted(held)[arg % len(held)]
            a.free(held.pop(key))
    return held


def _pair(ops):
    """The port's and repro's allocators after the same churn."""
    t, j = PageAllocator(POOL), JPageAllocator(POOL)
    held = _churn(t, ops)
    assert _churn(j, ops) == held and list(t.free_list) == list(j.free_list)
    return t, j, held


@settings(max_examples=200, deadline=None)
@given(ops=ops_strategy)
def test_auditor_blesses_honest_churn(ops):
    t, j, held = _pair(ops)
    assert same("check_allocator", (t, held), (j, held)) is None
    for key in list(held):
        pages = held.pop(key)
        t.free(pages)
        j.free(pages)
        assert same("check_allocator", (t, held), (j, held)) is None


@settings(max_examples=200, deadline=None)
@given(ops=ops_strategy,
       kind=st.sampled_from(["double_map", "leak", "stale_refcount", "out_of_pool"]),
       pick=st.integers(0, 1000))
def test_auditor_catches_injected_corruption(ops, kind, pick):
    t, j, held = _pair(ops)
    if not held:   # guarantee a live page to corrupt
        got = t.alloc(2)
        assert j.alloc(2) == got
        held[("slot", 0)] = list(got)
    key = sorted(held)[pick % len(held)]
    if not held[key]:
        got = t.alloc(1)
        assert j.alloc(1) == got
        held[key] = list(got or [])
        if not held[key]:
            held.pop(key)
            key = max(held, key=lambda k: len(held[k]))
    page = held[key][pick % len(held[key])]
    if kind == "double_map":
        held[("evil", -1)] = [page]
    elif kind == "leak":
        held[key] = [p for p in held[key] if p != page]
    elif kind == "stale_refcount":
        t.share([page])
        j.share([page])
    else:
        held[("evil", -1)] = [POOL + 3]
    assert same("check_allocator", (t, held), (j, held)) is not None


@settings(max_examples=100, deadline=None)
@given(cycle=st.lists(st.integers(1, POOL), max_size=30),
       corrupt=st.sampled_from(["none", "missing_rid", "ghost_rid", "byte_drift"]))
def test_auditor_swap_byte_conservation(cycle, corrupt):
    areas = (SwapArea(), JSwapArea())
    parked = []
    rid = 0
    for n in cycle:
        if parked and n % 2 == 0:
            prid, _ = parked.pop(0)
            for sa in areas:
                sa.pop(prid)
        else:
            data = np.zeros((n, 4), np.int8)
            for sa in areas:
                sa.put(rid, data)
            parked.append((rid, data))
            rid += 1
        assert same("check_swap", (areas[0], parked), (areas[1], parked)) is None
    assert same("check_swap", (None, []), (None, [])) is None
    if corrupt == "none" or not parked:
        return
    if corrupt == "missing_rid":
        for sa in areas:
            sa.pop(parked[0][0])
    elif corrupt == "ghost_rid":
        for sa in areas:
            sa.put(10 ** 6, np.zeros((1, 4), np.int8))
    else:
        parked[0] = (parked[0][0], np.zeros((parked[0][1].shape[0] + 1, 4), np.int8))
    assert same("check_swap", (areas[0], parked), (areas[1], parked)) is not None


def test_auditor_page_table_corruptions():
    """The table check passes a consistent state and catches each drift:
    wrong page, a mapping past the host list, a stale row on an empty slot,
    a frontier mismatch, an overrun extent, a lane behind its cursor and a
    private page aliased across rows — with the reference's messages."""
    rows = {0: [3, 5], 2: [7]}
    refcount = {3: 1, 5: 1, 7: 2}.get
    table = np.full((4, 4), -1, np.int32)
    table[0, :2] = [3, 5]
    table[2, 0] = 7
    lens = np.array([9, 0, 4, 0], np.int32)
    good = dict(exact_lens={0: 9}, min_lens={2: 4}, page_size=8)

    def check(tab, ln, host_rows, kw, match):
        msg = same("check_page_tables", (tab, ln, host_rows, refcount),
                   (tab, ln, host_rows, refcount), kw, kw)
        if match is None:
            assert msg is None
        else:
            assert msg is not None and match in msg

    check(table, lens, rows, good, None)
    bad = table.copy()
    bad[0, 1] = 6                       # wrong page
    check(bad, lens, rows, good, "host page list")
    bad = table.copy()
    bad[0, 2] = 9                       # mapped past the host list
    check(bad, lens, rows, good, "past its host page list")
    bad = table.copy()
    bad[1, 0] = 2                       # stale row on an empty slot
    check(bad, lens, rows, good, "holds no request")
    check(table, lens, rows, dict(exact_lens={0: 8}, page_size=8), "write frontier")
    check(table, np.array([17, 0, 4, 0], np.int32), rows, dict(exact_lens={0: 17}, page_size=8),
          "exceeds its mapped extent")
    check(table, np.array([9, 0, 3, 0], np.int32), rows, dict(min_lens={2: 4}, page_size=8),
          "fell behind")
    alias = np.full((4, 4), -1, np.int32)
    alias[0, 0] = alias[2, 0] = 3       # private page in two rows
    check(alias, lens, {0: [3], 2: [3]}, dict(page_size=8), "aliased")
