"""The plain reference against a naive loop, and the comparison that
decides ``correct`` on answers made right and made wrong."""

import numpy as np
import torch

from khi_bench import check, reference


def data(n=500, d=8, m=3, B=24, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs[7] = vecs[3]                               # a tie of two rows
    attrs = rng.integers(0, 10, size=(n, m)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    lo = rng.integers(0, 6, size=(B, m)).astype(np.float32)
    hi = lo + rng.integers(0, 6, size=(B, m)).astype(np.float32)
    lo[0] = 11                                      # an empty box
    lo[1], hi[1] = 0, 9                             # every row
    q[2] = vecs[3]
    return vecs, attrs, q, lo, hi


def naive(vecs, attrs, q, lo, hi, k):
    ids, dd, cnt = [], [], []
    for b in range(len(q)):
        cand = []
        for i in range(len(vecs)):
            if all(lo[b, j] <= attrs[i, j] <= hi[b, j]
                   for j in range(attrs.shape[1])):
                diff = vecs[i].astype(np.float64) - q[b].astype(np.float64)
                cand.append((float(diff @ diff), i))
        cand.sort()
        cnt.append(len(cand))
        top = cand[:k] + [(np.inf, -1)] * (k - len(cand[:k]))
        ids.append([i for _, i in top])
        dd.append([x for x, _ in top])
    return np.array(ids), np.array(dd), np.array(cnt)


def test_exact_topk_equals_a_naive_loop():
    vecs, attrs, q, lo, hi = data()
    k = 10
    t = [torch.as_tensor(x) for x in (vecs, attrs, q, lo, hi)]
    ids, dd, cnt = reference.exact_topk(*t, k, block=5, row_block=64)
    n_ids, n_dd, n_cnt = naive(vecs, attrs, q, lo, hi, k)
    np.testing.assert_array_equal(cnt.numpy(), n_cnt)
    np.testing.assert_array_equal(ids.numpy(), n_ids)
    np.testing.assert_allclose(dd.numpy(), n_dd, rtol=1e-12)
    assert (ids[0] == -1).all() and n_cnt[1] == len(vecs)


def judged(vecs, attrs, q, lo, hi, ids, dd, scan=None):
    return check.judge(torch.as_tensor(vecs), torch.as_tensor(attrs), q, lo,
                       hi, ids, dd, ids.shape[1], scan)


def test_judge_passes_exact_answers_and_flags_each_fault():
    vecs, attrs, q, lo, hi = data(seed=1)
    k = 10
    ids, dd, _ = naive(vecs, attrs, q, lo, hi, k)
    ids, dd = ids.astype(np.int32), dd.astype(np.float32)
    scan = np.ones(len(q), bool)
    good = judged(vecs, attrs, q, lo, hi, ids, dd, scan)
    assert good["recall_at_k"] == 1.0
    assert good["dist_rel_gap"] < 1e-6
    assert all(good[x] == 0 for x in ("short_lanes", "exact_lane_misses",
                                       "box_violations",
                                       "order_violations"))
    assert good["recall_miss"] == 0.0
    lims = {"dist_rel_gap": 1e-4, "short_lanes": 0, "exact_lane_misses": 0,
            "box_violations": 0, "order_violations": 0, "recall_miss": 0.1}
    assert all(c["ok"] for c in check.compare(good, lims).values())

    # half of the lanes left out
    bad_i, bad_d = ids.copy(), dd.copy()
    bad_i[12:], bad_d[12:] = -1, np.inf
    r = judged(vecs, attrs, q, lo, hi, bad_i, bad_d, scan)
    assert r["short_lanes"] > 0 and r["recall_at_k"] < 0.75
    assert r["recall_miss"] == 1.0 - r["recall_at_k"]
    assert not check.compare(r, lims)["recall_miss"]["ok"]
    # distances altered by 2**-10
    r = judged(vecs, attrs, q, lo, hi, ids, dd * (1 + 2.0 ** -10), scan)
    assert r["dist_rel_gap"] > 5e-4
    # a row outside its box in a lane's first slot
    lane = 5
    outside = np.nonzero(~((attrs >= lo[lane]) & (attrs <= hi[lane])
                           ).all(1))[0][0]
    bad_i = ids.copy()
    bad_i[lane, 0] = outside
    r = judged(vecs, attrs, q, lo, hi, bad_i, dd, scan)
    assert r["box_violations"] == 1
    # a repeated id, and two slots swapped
    bad_i = ids.copy()
    bad_i[6, 1] = bad_i[6, 0]
    assert judged(vecs, attrs, q, lo, hi, bad_i, dd)["order_violations"] == 1
    bad_i, bad_d = ids.copy(), dd.copy()
    bad_i[6, [0, 1]] = bad_i[6, [1, 0]]
    bad_d[6, [0, 1]] = bad_d[6, [1, 0]]
    assert judged(vecs, attrs, q, lo, hi, bad_i, bad_d)["order_violations"]
    # an exact lane that misses its nearest row, another in-box row in
    # its place
    lane = 1
    spare = [i for i in range(len(vecs)) if i not in set(ids[lane])][0]
    bad_i, bad_d = ids.copy(), dd.copy()
    bad_i[lane, -1] = spare
    diff = vecs[spare].astype(np.float64) - q[lane]
    bad_d[lane, -1] = float(diff @ diff)
    r = judged(vecs, attrs, q, lo, hi, bad_i, bad_d, scan)
    assert r["exact_lane_misses"] >= 1


def test_ties_count_as_hits():
    vecs, attrs, q, lo, hi = data(seed=2)
    attrs[7] = attrs[3]                 # rows 3 and 7 now equal in full
    lane = 1                            # the box that holds every row
    q[lane] = vecs[3] + 0.5
    ids, dd, _ = naive(vecs, attrs, q, lo, hi, 1)
    assert ids[lane, 0] == 3            # the lower id first
    ids = ids.astype(np.int32)
    ids[lane, 0] = 7
    r = judged(vecs, attrs, q, lo, hi, ids, dd.astype(np.float32),
               np.ones(len(q), bool))
    assert r["exact_lane_misses"] == 0 and r["recall_at_k"] == 1.0
