"""The plain reference against the port's CPU path, bit for bit, at a size
a test run holds; and its control (bfloat16) off."""
import numpy as np
import pytest

from portbench import frozen, reference

POLICIES = list(frozen.POLICY_WEIGHTS)


def _inputs(gen, n, t, seed):
    ids, sizes = frozen.GENERATORS[gen](n, t, seed)
    costs = np.stack([frozen.miss_costs(sizes, p)
                      for p in frozen.PRICE_VECTORS])
    return ids, sizes, costs


@pytest.mark.parametrize("gen,n,budgets", [
    ("twemcache_like", 300, [8, 16, 40, 100]),
    ("wiki_cdn_like", 900, [10, 20, 60, 150])])
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_reference_equals_port_cpu_path(gen, n, budgets, seed):
    from repro_torch.core.policies_torch import sweep_torch
    ids, sizes, costs = _inputs(gen, n, 2500, seed)
    d, h = sweep_torch(POLICIES, ids, costs, np.array(budgets),
                       num_objects=n, sizes=sizes, device="cpu",
                       return_hits=True)
    rd, rh = reference.replay_grid(ids, costs, sizes,
                                   frozen.policy_weights(POLICIES), budgets)
    assert np.array_equal(h, rh)
    assert np.array_equal(d.view(np.int32), rd.view(np.int32))


def test_control_is_off():
    ids, sizes, costs = _inputs("twemcache_like", 300, 2500, 3)
    w = frozen.policy_weights(POLICIES)
    d, h = reference.replay_grid(ids, costs, sizes, w, [8, 16, 40, 100])
    bd, bh = reference.replay_grid(ids, costs, sizes, w, [8, 16, 40, 100],
                                   precision="bf16")
    assert (bh != h).sum() > 0
    assert (bd.view(np.int32) != d.view(np.int32)).sum() > 0


def test_workers_give_the_same_grid():
    ids, sizes, costs = _inputs("wiki_cdn_like", 600, 1500, 4)
    w = frozen.policy_weights(POLICIES)
    one = reference.replay_grid(ids, costs, sizes, w, [10, 40])
    two = reference.replay_grid(ids, costs, sizes, w, [10, 40], workers=2)
    assert np.array_equal(one[0].view(np.int32), two[0].view(np.int32))
    assert np.array_equal(one[1], two[1])


def _child_pids() -> set:
    from portbench import run
    return {pid for pid, _ in run.children()}


def test_workers_leave_no_process():
    ids, sizes, costs = _inputs("wiki_cdn_like", 300, 600, 5)
    w = frozen.policy_weights(POLICIES)
    before = _child_pids()
    reference.replay_grid(ids, costs, sizes, w, [10, 40], workers=3)
    assert _child_pids() <= before


def test_a_failing_worker_leaves_no_process():
    ids, sizes, costs = _inputs("wiki_cdn_like", 300, 600, 6)
    w = frozen.policy_weights(POLICIES)
    before = _child_pids()
    with pytest.raises(Exception):
        reference.replay_grid(ids, costs, sizes, w, [10, 40],
                              precision="no such precision", workers=2)
    assert _child_pids() <= before


def test_next_use_and_counts_by_definition():
    ids = np.random.default_rng(0).integers(0, 7, size=200)
    nxt, cnt = reference.next_use(ids), reference.request_counts(ids)
    for t, i in enumerate(ids):
        later = [u for u in range(t + 1, len(ids)) if ids[u] == i]
        assert nxt[t] == (later[0] if later else len(ids))
        assert cnt[t] == int((ids[:t + 1] == i).sum())


def test_lru_by_hand():
    # budget 2: a b a c b -> miss miss hit miss(evict b) miss(evict a)
    ids = np.array([0, 1, 0, 2, 1])
    costs, sizes = np.array([1.0, 2.0, 4.0]), np.ones(3)
    nxt, cnt = reference.next_use(ids), reference.request_counts(ids)
    d, h = reference.replay_cell(ids, nxt, cnt, costs, sizes,
                                 frozen.POLICY_WEIGHTS["lru"], 2)
    assert (d, h) == (9.0, 1)
    d, h = reference.replay_cell(ids, nxt, cnt, costs, sizes,
                                 frozen.POLICY_WEIGHTS["belady"], 2)
    # Belady at c: evicts a (never again) and keeps b, so b hits
    assert (d, h) == (7.0, 2)
