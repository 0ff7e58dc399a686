"""The Router's elastic surface on the port, held to the reference's: the
counterparts of ``tests/test_cluster_elastic.py`` (the bounded LRU
affinity memo and its eviction counter, a retry-backoff request migrated
with its penalty re-based onto the destination's step clock, and the
merge/split drains that empty or populate a replica through the
migration facade).

The cases run on both packages as in ``tests/test_torch_cluster.py``
(whose ``Side``, weights and result helpers they share): the port's
streams, owners, transfer log, ClusterStats and merged dump must be
JSON-equal to the reference's, and the reference test's assertions then
run on the port's results.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.cluster import Router  # noqa: E402
from test_torch_cluster import Side, _cluster, _js, weights  # noqa: E402,F401


def _reqs(s, n=3, max_new=6):
    return [s.Request(i, list(range(1, 14 + 3 * i)), max_new_tokens=max_new)
            for i in range(n)]


def case_lru(s):
    router = s.Router([s.engine(), s.engine()], routing="affinity",
                      rebalance_every=0, affinity_cap=2)
    # distinct prompts of a block, never prefilled: each submit drops a
    # memo entry; the cap holds and the coldest entry is the one evicted
    for i in range(5):
        router.submit(s.Request(i, list(range(100 * (i + 1),
                                              100 * (i + 1) + 8)),
                                max_new_tokens=2))
    out = {"memo": len(router._affinity),
           "evictions": [router.affinity_evictions,
                         router.stats().affinity_evictions]}
    hot = list(range(900, 908))
    router.submit(s.Request(10, hot, max_new_tokens=2))
    router.submit(s.Request(11, hot, max_new_tokens=2))       # bump
    router.submit(s.Request(12, list(range(1000, 1008)), max_new_tokens=2))
    out["evictions_after"] = router.affinity_evictions
    router.submit(s.Request(13, hot, max_new_tokens=2))       # memo survived
    out.update(_cluster(router, [0, 1, 2, 3, 4, 10, 11, 12, 13]))
    return out


def case_backoff(s):
    ref_eng = s.engine(prefix=False)
    ref = _reqs(s)
    for r in ref:
        ref_eng.add_request(r)
    ref_eng.run_until_idle(max_steps=2000)
    router = s.Router([s.engine(prefix=False), s.engine(prefix=False)],
                      routing="round-robin", rebalance_every=0)
    reqs = _reqs(s)
    for r in reqs:
        router.submit(r)
    for _ in range(6):                     # prefill + a few decode steps
        router.poll()
        router.step()
    src_i = router.owner(0)
    src, dst = router.engines[src_i], router.engines[1 - src_i]
    req = src.request(0)
    held = req is not None and req.slot is not None
    req.retry_at = src.step_count + 5      # a retry-backoff window
    migratable = 0 in src.migratable()
    for _ in range(3):                     # skew the destination's clock
        dst.step()
    ops = router.migrate(0, 1 - src_i)
    moved = dst.request(0)
    out = _cluster(router, [r.rid for r in reqs])
    out.update(held=held, migratable=migratable, ok=ops is not None,
               rebased=moved.retry_at == dst.step_count + 5)
    router.run_until_idle()
    out.update(final=_cluster(router, [r.rid for r in reqs]),
               expect={r.rid: list(r.generated) for r in ref})
    return out


def case_merge_split(s):
    ref_eng = s.engine(prefix=False)
    ref = _reqs(s, n=4, max_new=8)
    for r in ref:
        ref_eng.add_request(r)
    ref_eng.run_until_idle(max_steps=2000)
    router = s.Router([s.engine(prefix=False), s.engine(prefix=False)],
                      routing="round-robin", rebalance_every=0)
    reqs = _reqs(s, n=4, max_new=8)
    for r in reqs:
        router.submit(r)
    for _ in range(5):
        router.poll()
        router.step()
    try:
        router.merge_replicas(0, 0)
        same_raises = False
    except ValueError:
        same_raises = True
    live_on_1 = [rid for rid, i in router._owner.items() if i == 1
                 and router.engines[1].request(rid).finish_reason is None]
    moved = router.merge_replicas(0, 1)
    st1 = router.engines[1].stats()
    merged = {"moved": moved, "live": live_on_1,
              "owners": [router.owner(rid) for rid in live_on_1],
              "emptied": (st1.active, st1.queue_depth)}
    live_on_0 = [rid for rid, i in router._owner.items() if i == 0
                 and router.engines[0].request(rid).finish_reason is None]
    back = router.split_replica(0, 1)
    split = {"back": back, "live": live_on_0,
             "on_1": sum(1 for rid in live_on_0 if router.owner(rid) == 1)}
    router.run_until_idle()
    out = _cluster(router, [r.rid for r in reqs])
    out.update(same_raises=same_raises, merged=merged, split=split,
               expect={r.rid: list(r.generated) for r in ref})
    return out


CASES = {"lru": case_lru, "backoff": case_backoff,
         "merge-split": case_merge_split}


@pytest.fixture(scope="module")
def runs(weights):  # noqa: F811
    sides = {name: Side(name, weights) for name in ("reference", "port")}
    return {case: {name: fn(s) for name, s in sides.items()}
            for case, fn in CASES.items()}


def _port(runs, case):
    want, got = runs[case]["reference"], runs[case]["port"]
    assert got.keys() == want.keys()
    for key in want:
        assert _js(got[key]) == _js(want[key]), (case, key)
    return got


def test_affinity_cap_validates():
    with pytest.raises(ValueError):
        Router([object()], affinity_cap=0)


def test_affinity_memo_is_lru_bounded(runs):
    got = _port(runs, "lru")
    assert got["memo"] == 2 and got["evictions"] == [3, 3]
    # LRU, not FIFO: the bumped prefix keeps its replica, the cold one goes
    owners = got["owners"]
    assert owners[11] == owners[10]
    assert got["evictions_after"] == 5
    assert owners[13] == owners[10]


def test_backoff_request_migrates_with_rebased_penalty(runs):
    got = _port(runs, "backoff")
    assert got["held"] and got["migratable"] and got["ok"]
    assert got["rebased"]                      # re-based, not copied
    final = got["final"]
    assert final["streams"] == got["expect"]   # bit-identical across move
    assert final["delivered"][0] == got["expect"][0]


def test_merge_and_split_replicas(runs):
    got = _port(runs, "merge-split")
    assert got["same_raises"]
    m = got["merged"]
    assert m["moved"] == len(m["live"])
    assert m["owners"] == [0] * len(m["live"])
    assert m["emptied"] == (0, 0)
    sp = got["split"]
    assert sp["back"] == len(sp["live"]) // 2 == sp["on_1"]
    assert got["streams"] == got["expect"]     # survive merge + split
