"""The traffic generator: deterministic from the seed, the same set of
sizes for every seed, the medians of its sources."""
import numpy as np
import pytest

from harness import cells, draws

SEED = 2 ** 31 + 977          # larger than 32 signed bits hold


MIXES = ["azure-conv", "sharegpt"]


def _sizes(traffic, n):
    return [traffic.sizes(c, j) for c in range(traffic.clients)
            for j in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_mix_is_deterministic_and_within_its_bounds(name):
    m = cells.mix(name)
    kind = cells.module("traffic/kinds", m["kind"])
    a = _sizes(kind.Traffic(m["params"], SEED, 1000), 64)
    assert a == _sizes(kind.Traffic(m["params"], SEED, 1000), 64)
    b = _sizes(kind.Traffic(m["params"], SEED + 1, 1000), 64)
    assert a != b
    # the same streams, dealt to the clients in another order
    assert sorted(a) == sorted(b)
    p = m["params"]
    ins, outs = zip(*a)
    assert p["prompt"]["min"] <= min(ins) and max(ins) <= p["prompt"]["max"]
    assert 1 <= min(outs) and max(outs) <= p["output"]["max"]
    assert np.array_equal(draws.prompt(SEED, 5, 30, 1000),
                          draws.prompt(SEED, 5, 30, 1000))


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", [SEED, 7])
def test_closed_loop_streams_cover_the_distribution_evenly(seed, name):
    m = cells.mix(name)
    t = cells.module("traffic/kinds", "closed").Traffic(m["params"], seed,
                                                        1000)
    spec = m["params"]["output"]
    # every client's first 20 requests after the first: their quantiles
    # leave at most 4 of the twentieths of [0, 1) empty (random draws
    # leave about 7)
    for i in range(t.clients):
        us = [t.outputs[i].u(j) for j in range(1, 21)]
        counts = np.bincount((np.array(us) * 20).astype(int), minlength=20)
        assert (counts == 0).sum() <= 4
    # the medians of a seed's first requests lie near the mix's
    outs = [t.sizes(c, j)[1] for c in range(t.clients) for j in range(1, 9)]
    assert abs(np.median(outs) / spec["median"] - 1) < 0.15


def _quantiles(spec, n):
    return np.array([draws.quantile(spec, (i + 0.5) / n) for i in range(n)])


def test_lognormal_median_and_clip():
    spec = {"dist": "lognormal", "median": 1020, "sigma": 0.8, "min": 100,
            "max": 3576}
    xs = _quantiles(spec, 2001)
    assert np.median(xs) == 1020
    assert xs.min() == 100 and xs.max() == 3576


def test_uniform_covers_both_ends_evenly():
    spec = {"dist": "uniform", "min": 4, "max": 32}
    xs = _quantiles(spec, 29 * 10).astype(int)
    assert np.bincount(xs)[4:33].tolist() == [10] * 29


@pytest.mark.parametrize("name,key,mean", [("sharegpt", "prompt", 161.31),
                                           ("sharegpt", "output", 337.99)])
def test_clipped_means_match_the_source(name, key, mean):
    spec = cells.mix(name)["params"][key]
    assert abs(_quantiles(spec, 20001).mean() / mean - 1) < 0.01


def test_residual_lengths_are_length_biased():
    spec = {"dist": "lognormal", "median": 128, "sigma": 0.8, "min": 16,
            "max": 512}
    u = (np.arange(1000) + 0.5) / 1000
    full = draws.residual(spec, u, np.ones(1000))
    assert full.min() >= 16 and full.max() <= 512
    # a length drawn in proportion to it: longer than the plain median
    assert np.median(full) > 1.5 * 128
    assert np.all(draws.residual(spec, u, np.full(1000, 0.5))
                  <= np.ceil(full / 2))
