"""The benchmark's frozen copies give the program's arrays bit for bit."""
import numpy as np
import pytest

from portbench import frozen, peaks


@pytest.mark.parametrize("name", sorted(frozen.GENERATORS))
@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 17, 2**63 + 3])
def test_generators_match_the_program(name, seed):
    from repro_torch.core import trace
    ids, sizes = frozen.GENERATORS[name](3000, 20000, seed)
    tr = getattr(trace, name)(n_objects=3000, n_requests=20000, seed=seed)
    assert np.array_equal(ids, tr.ids) and ids.dtype == tr.ids.dtype
    assert np.array_equal(sizes.view(np.int64), tr.sizes.view(np.int64))


def test_prices_and_costs_match_the_program():
    from repro_torch.core import pricing
    assert set(frozen.PRICE_VECTORS) == set(pricing.PRICE_VECTORS)
    sizes = frozen.twemcache_like(500, 2000, 9)[1]
    for name, (fee, egress) in frozen.PRICE_VECTORS.items():
        pv = pricing.PRICE_VECTORS[name]
        assert (fee, egress) == (pv.get_fee, pv.egress_per_byte)
        assert pv.latency_penalty == 0.0
        ours = frozen.miss_costs(sizes, name)
        assert np.array_equal(ours.view(np.int64),
                              pricing.miss_costs(sizes, pv).view(np.int64))


def test_policy_weights_match_the_program():
    from repro_torch.core.policies_torch import (POLICY_WEIGHTS,
                                                 stack_policy_weights)
    assert set(frozen.POLICY_WEIGHTS) == set(POLICY_WEIGHTS)
    names = list(frozen.POLICY_WEIGHTS)
    assert np.array_equal(
        frozen.policy_weights(names).astype(np.float32),
        stack_policy_weights(names))


def test_peaks_match_the_program():
    from repro_torch.launch import roofline
    assert peaks.F32_FLOPS == roofline.F32_PEAK_FLOPS
    assert peaks.BF16_FLOPS == roofline.PEAK_FLOPS
    assert peaks.HBM_BYTES_S == roofline.HBM_BW
