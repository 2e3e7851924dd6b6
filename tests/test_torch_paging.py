"""Port parity for the paged cache's host-side policy: ``PageAllocator``,
``PrefixIndex``, ``SwapArea`` (``serve/paging.py``), ``AdmissionPlanner``
and ``pick_preemption_victim`` (``serve/admission.py``) against repro's on
the same seeded operation sequences.  Every answer is an integer, a list
or an exception, so each is held equal."""
import numpy as np
import pytest

from repro.serve import admission as j_adm
from repro.serve import paging as j_paging
from repro_torch.serve import admission as t_adm
from repro_torch.serve import paging as t_paging


def _call(obj, name, *args):
    """(result, exception type and message) of one method call."""
    try:
        return getattr(obj, name)(*args), None
    except (ValueError, KeyError) as e:
        return None, (type(e).__name__, str(e))


def _alloc_state(a):
    return (a.free_pages, a.pages_in_use, tuple(a.free_list), a.peak_in_use,
            tuple(a.refcount(p) for p in range(a.num_pages)))


@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_reference_under_seeded_churn(seed):
    """alloc / share / free / over-free in a random order, pool of 10:
    LIFO reuse, all-or-nothing alloc, refcounts and the loud over-free."""
    rng = np.random.default_rng(seed)
    ja, ta = j_paging.PageAllocator(10), t_paging.PageAllocator(10)
    held = []
    for _ in range(300):
        op = rng.choice(["alloc", "share", "free", "overfree"], p=[0.4, 0.2, 0.3, 0.1])
        if op == "alloc":
            args = (int(rng.integers(0, 7)),)
        elif held:
            args = (held[int(rng.integers(len(held)))],)
        else:
            continue
        name = "free" if op == "overfree" else op
        if op == "overfree":
            args = (args[0] + args[0],)
        got, want = _call(ta, name, *args), _call(ja, name, *args)
        assert got == want, (op, args)
        if op == "alloc" and got[0] is not None:
            held.append(got[0])
        elif op == "share" and got[1] is None:
            held.append(args[0])
        elif op == "free" and got[1] is None:
            held.remove(args[0])
        assert _alloc_state(ta) == _alloc_state(ja)


def test_allocator_exhaustion_and_bad_arguments_match_reference():
    ja, ta = j_paging.PageAllocator(4), t_paging.PageAllocator(4)
    for name, args in (("alloc", (3,)), ("alloc", (2,)), ("alloc", (1,)), ("alloc", (0,)),
                       ("alloc", (-1,)), ("share", ([9],)), ("free", ([0, 0, 0],)),
                       ("free", ([1, 2],)), ("alloc", (2,))):
        assert _call(ta, name, *args) == _call(ja, name, *args), (name, args)
        assert _alloc_state(ta) == _alloc_state(ja)
    with pytest.raises(ValueError, match="num_pages"):
        t_paging.PageAllocator(0)


@pytest.mark.parametrize("ps", [1, 4, 8])
def test_prefix_index_matches_reference(ps):
    """Cumulative digests over full pages, longest chain, first writer wins,
    drop on release, on one seeded sequence of prompts sharing openings."""
    rng = np.random.default_rng(ps)
    ji, ti = j_paging.PrefixIndex(ps), t_paging.PrefixIndex(ps)
    base = rng.integers(0, 50, size=40).astype(np.int32)
    next_page = 0
    for step in range(40):
        cut = int(rng.integers(1, 40))
        prompt = base.copy()
        prompt[cut:] = rng.integers(0, 50, size=40 - cut)
        prompt = prompt[:int(rng.integers(1, 41))]
        assert ti.digests(prompt) == ji.digests(prompt)
        assert ti.match(prompt) == ji.match(prompt), step
        keys = ti.digests(prompt)
        assert ti.match_keys(keys) == ji.match_keys(keys)
        pages = list(range(next_page, next_page + len(keys)))
        next_page += len(keys)
        if step % 3:
            ti.insert(prompt, pages)
            ji.insert(prompt, pages)
        else:
            ti.insert_keys(keys, pages)
            ji.insert_keys(keys, pages)
        if step % 5 == 4:
            drop = [int(x) for x in rng.integers(0, next_page, size=3)]
            ti.drop_pages(drop)
            ji.drop_pages(drop)
        assert ti._page_of == ji._page_of and ti._key_of == ji._key_of
    with pytest.raises(ValueError, match="page_size"):
        t_paging.PrefixIndex(0)


def test_swap_area_and_tree_bytes_match_reference():
    rng = np.random.default_rng(0)
    trees = [None,
             {"k": np.zeros((2, 8, 2, 4), np.int8), "v": np.zeros(16, np.float32)},
             [{"k": rng.normal(size=(4, 3)), "v": rng.integers(0, 3, (5,), np.int8)}] * 2,
             (np.zeros(3, np.int32), [np.zeros(7, np.int8)])]
    for tree in trees:
        assert t_paging._tree_bytes(tree) == j_paging._tree_bytes(tree)
    cap = t_paging._tree_bytes(trees[1]) + t_paging._tree_bytes(trees[2])
    js, ts = j_paging.SwapArea(cap), t_paging.SwapArea(cap)
    for name, args in (("put", (1, trees[1])), ("put", (1, trees[1])), ("put", (2, trees[2])),
                       ("put", (3, trees[3])), ("pop", (1,)), ("pop", (1,)),
                       ("put", (3, trees[3])), ("put", (4, None)), ("pop", (4,)),
                       ("pop", (2,)), ("pop", (3,))):
        got, want = _call(ts, name, *args), _call(js, name, *args)
        assert got[0] is want[0], (name, args)      # pop hands back the parked tree
        assert (got[1] is None) == (want[1] is None), (name, args)
        if got[1] is not None:
            assert got[1][0] == want[1][0]
        assert (ts.bytes_held, ts.peak_bytes, len(ts), ts.fits(100)) == \
            (js.bytes_held, js.peak_bytes, len(js), js.fits(100))
    with pytest.raises(ValueError, match="capacity_bytes"):
        t_paging.SwapArea(-1)


@pytest.mark.parametrize("seed", range(3))
def test_victim_selection_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(0, 6))
        cands = [(j, int(rng.integers(0, 8)), int(rng.integers(0, 5)), int(rng.integers(0, 9)))
                 for j in range(n)]
        counts = {int(r): int(rng.integers(0, 4)) for r in rng.integers(0, 8, size=4)}
        bound = int(rng.integers(1, 4))
        assert t_adm.pick_preemption_victim(cands, counts, bound) == \
            j_adm.pick_preemption_victim(cands, counts, bound)


class _Req:
    def __init__(self, rid, prompt, max_new):
        self.rid, self.prompt, self.max_new = rid, prompt, max_new


@pytest.mark.parametrize("oversubscribe", [False, True], ids=["upfront", "oversub"])
@pytest.mark.parametrize("ps,chunk", [(4, 4), (8, 6), (3, 8)])
def test_admission_planner_matches_reference(oversubscribe, ps, chunk):
    """Seeded admissions against one pool and index: plans (row, copies,
    shared count, start), stalls (None), refcounts and the index, equal."""
    max_pages = -(-48 // ps)
    kw = dict(page_size=ps, max_pages=max_pages, chunk_size=chunk,
              oversubscribe=oversubscribe)
    jp, tp = j_adm.AdmissionPlanner(**kw), t_adm.AdmissionPlanner(**kw)
    ja, ta = j_paging.PageAllocator(3 * max_pages), t_paging.PageAllocator(3 * max_pages)
    ji, ti = j_paging.PrefixIndex(ps), t_paging.PrefixIndex(ps)
    rng = np.random.default_rng(ps * chunk)
    sysp = rng.integers(0, 50, size=24).astype(np.int32)
    live = []
    for rid in range(30):
        plen = int(rng.integers(1, 30))
        prompt = np.concatenate([sysp, rng.integers(0, 50, size=30).astype(np.int32)])[:plen]
        if rid % 4 == 3:
            prompt = sysp[:plen] if plen <= 24 else prompt
        r = _Req(rid, prompt, int(rng.integers(1, 48 - plen + 1)))
        assert tp.pages_needed(plen, r.max_new) == jp.pages_needed(plen, r.max_new)
        keys = ti.digests(prompt) if rid % 2 else None
        got = tp.plan(r, plen, ta, ti, keys=keys)
        want = jp.plan(r, plen, ja, ji, keys=keys)
        if want is None:
            assert got is None, rid
        else:
            rp, cp, ns, st = want
            assert got == (list(rp), list(cp), ns, st), rid
            np.testing.assert_array_equal(tp.page_row(got[0]), np.asarray(jp.page_row(rp)))
            ti.insert(prompt, got[0][:plen // ps])
            ji.insert(prompt, rp[:plen // ps])
            live.append(got[0])
        assert _alloc_state(ta) == _alloc_state(ja)
        if live and (want is None or rid % 3 == 0):
            pages = live.pop(int(rng.integers(len(live))))
            ti.drop_pages(ta.free(pages))
            ji.drop_pages(ja.free(pages))


def test_plan_that_cannot_cover_real_rows_raises():
    """A request past the table raises before it takes any page; up front
    the decode horizon counts, oversubscribed only the prompt."""
    for over, max_new, raises in ((False, 40, True), (True, 40, False), (True, 1, False)):
        for mod in (j_adm, t_adm):
            planner = mod.AdmissionPlanner(page_size=8, max_pages=6, chunk_size=8,
                                           oversubscribe=over)
            alloc = (j_paging if mod is j_adm else t_paging).PageAllocator(12)
            r = _Req(0, np.zeros(16, np.int32), max_new)
            if raises:
                with pytest.raises(ValueError, match="out-of-bounds sentinel"):
                    planner.plan(r, 16, alloc, None)
                assert alloc.pages_in_use == 0
            else:
                assert planner.plan(r, 16, alloc, None)[0] == [0, 1]
    # a padded last chunk past the table is clamped, not refused
    planner = t_adm.AdmissionPlanner(page_size=4, max_pages=5, chunk_size=8)
    row, _, _, start = planner.plan(_Req(1, np.zeros(17, np.int32), 3), 17,
                                    t_paging.PageAllocator(8), None)
    assert len(row) == 5 and start == 0


def test_assert_private_write_names_the_shared_page():
    alloc = t_paging.PageAllocator(6)
    pages = alloc.alloc(3)
    alloc.share(pages[:1])
    planner = t_adm.AdmissionPlanner(page_size=4, max_pages=3, chunk_size=4)
    planner.assert_private_write(pages, 4, 12, alloc)
    with pytest.raises(AssertionError, match=f"shared page {pages[0]}"):
        planner.assert_private_write(pages, 2, 6, alloc)
