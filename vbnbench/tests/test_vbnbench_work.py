"""The work counts against hand counts: asia (categorical tables) and a
two-node KDE network."""

from types import SimpleNamespace

import numpy as np
import pytest

from vbnbench import peaks, registry
from vbnbench.networks.discrete import DiscreteNet
from vbnbench.traffic import Call

ASIA = {"asia": [], "tub": ["asia"], "smoke": [], "lung": ["smoke"],
        "bronc": ["smoke"], "either": ["tub", "lung"], "xray": ["either"],
        "dysp": ["either", "bronc"]}


def asia():
    net = DiscreteNet(name="asia")
    for n, ps in ASIA.items():
        net.nodes.append(n)
        net.cards[n] = 2
        net.parents[n] = ps
        net.cpts[n] = np.full((2,) * len(ps) + (2,), 0.5)
    return net


def test_categorical_hand_count():
    # target dysp, evidence asia and xray; S = 1:
    # asia 1 + 4 (evidence: row, total, divide, floor; 1 log)
    # tub, lung, bronc 3 + 32; smoke 1 + 32; either 5 + 32; dysp 5 + 32
    # xray 3 + 4 (1 log); reduction 4 (1 exp) -> 228 ops, 3 special
    call = Call(queries=[], kwargs={"n_classes": 2},
                rows=[("dysp", {"asia": 0, "xray": 1})])
    got = registry.work_counter("categorical_table").count(asia(), call, 1)
    assert got["ops"] == 228 and got["sfu"] == 3 and got["tc"] == 0
    # bytes: 3 inputs for the row, 36 CPT entries, 2 outputs, 4 bytes each
    assert got["bytes"] == 4 * (3 + 36 + 2)
    twice = registry.work_counter("categorical_table").count(asia(), call, 1000)
    assert twice["ops"] == 228 * 1000 and twice["bytes"] == got["bytes"]


def test_kde_hand_count():
    net = SimpleNamespace(nodes=["x0", "x1"], parents={"x0": [], "x1": ["x0"]},
                          support={"x0": 10, "x1": 10})
    count = registry.work_counter("kde").count
    # x0 latent root: 29 + 59 + 2 = 90 ops, 3 special; x1 evidence with one
    # parent: 2 (1 + 1) 10 = 40 tensor-core flops, 80 ops, 22 special;
    # reduction 7 ops, 1 special
    one = count(net, Call([], {}, [("x0", {"x1": 0.5})]), 1)
    assert (one["ops"], one["sfu"], one["tc"]) == (177, 26, 40)
    # points: x0 10 (0 + 2), x1 10 (1 + 2); 2 inputs; 2 outputs
    assert one["bytes"] == 4 * (50 + 2 + 2)
    # x1 latent with one parent: 90 + (2 + 6) 10 = 170 ops, 3 + 10 special
    two = count(net, Call([], {}, [("x1", {})]), 1)
    assert (two["ops"], two["sfu"], two["tc"]) == (90 + 170 + 7, 3 + 13 + 1, 0)


def test_least_ms_takes_the_largest_bound():
    assert peaks.least_ms({"ops": peaks.PEAK_OPS}) == pytest.approx(1e3)
    assert peaks.least_ms({"ops": 1.0, "bytes": peaks.PEAK_BYTES * 2}) == \
        pytest.approx(2e3)
    assert peaks.least_ms({"sfu": peaks.PEAK_SFU, "tc": 1.0}) == pytest.approx(1e3)
