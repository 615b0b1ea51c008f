"""chip_smoke.py's comparison helpers and its refusal to run off the GPU.

The phases themselves need a card; what they decide with is plain numpy and
is pinned here on CPU arrays.
"""

import numpy as np
import pytest

import chip_smoke as cs


def _status_r(n, seed=0):
    rng = np.random.default_rng(seed)
    status = rng.choice(np.array([1, 2, 4], np.int32), size=n)
    r = rng.uniform(1.5, 900.0, size=n)
    return status, r


@pytest.mark.parametrize(
    "flips, dr_rel, stuck, ok",
    [
        (0, 0.0, 0, True),
        (40, 1e-6, 0, True),  # 0.4% flipped statuses: chaotic rays, allowed
        (60, 1e-6, 0, False),  # 0.6% flipped: over the 99.5% gate
        (0, 3e-4, 0, False),  # positions off by more than 1e-4
        (0, 0.0, 1, False),  # one stuck ray
    ],
)
def test_engine_agreement_gates(flips, dr_rel, stuck, ok):
    status, r = _status_r(10_000)
    live = np.ones(status.shape, bool)
    live[-5:] = False  # dead padding never counts
    a_status = status.copy()
    a_status[:flips] = np.where(a_status[:flips] == 1, 2, 1)
    a_status[flips:flips + stuck] |= 8
    b_status = status.copy()
    b_status[flips:flips + stuck] |= 8
    a_r = r * (1 + dr_rel)
    res = cs.engine_agreement(a_status, a_r, b_status, r, live)
    assert res["ok"] is ok
    assert res["status_agree"] == pytest.approx(1 - flips / live.sum())
    assert res["stuck_kernel"] == stuck


def test_engine_agreement_ignores_dead_rays():
    status, r = _status_r(1000)
    live = np.arange(1000) < 900
    a_status = status.copy()
    a_status[900:] = 8  # stuck-looking padding, outside `live`
    res = cs.engine_agreement(a_status, r, status, r, live)
    assert res["ok"] and res["stuck_kernel"] == 0


def test_gated_bins():
    ref = np.array([50, 100, 400, 1000, 2000], float)
    mine = ref.copy()
    mine[3] *= 1.2  # one bin off by 20%
    mine[0] = 200  # enough rays here, but the reference bin is too sparse
    np.testing.assert_array_equal(cs.gated_bins(mine, ref),
                                  [False, True, True, False, True])


def test_profile_deviation():
    ref = {"emis": np.array([1.0, 2.0]), "redshift": np.array([0.9, 1.1]),
           "time": np.array([10.0, 20.0])}
    mine = {"emis": ref["emis"] * 1.05, "redshift": ref["redshift"] * 1.004,
            "time": ref["time"]}
    both = np.array([True, True])
    dev = cs.profile_deviation(mine, ref, both)
    assert dev["emis"]["pass"] and dev["emis"]["max_dev"] == pytest.approx(0.05)
    assert dev["redshift"]["pass"]  # 0.4% < 0.5%
    mine["redshift"] = ref["redshift"] * 1.006
    assert not cs.profile_deviation(mine, ref, both)["redshift"]["pass"]
    # no gated bin is no evidence
    assert not cs.profile_deviation(mine, ref, ~both)["emis"]["pass"]


def test_cumulative_rows_deviation():
    """A finer run of the same profile stays within one reference row of
    the reference's staircase cumulative count, per primary ray."""
    row = 126
    ref = np.array([0, row, 0, 2 * row, row, 0], float)  # whole rows per bin
    mine = np.array([10, 90, 40, 230, 130, 0], float) * 10  # 10x the primaries
    dev = cs.cumulative_rows_deviation(mine, ref, 0.1, row)
    assert dev < 1.0
    assert cs.cumulative_rows_deviation(mine * 1.5, ref, 0.1, row) > 1.0


def test_sharded_agreement():
    counts = np.array([[0, 3], [5, 7]])
    maps = {"flux": np.array([[np.nan, 1.0], [2.0, 3.0]])}
    close = {"flux": maps["flux"] * (1 + 1e-7)}
    assert cs.sharded_agreement(counts, counts, close, maps)["ok"]
    far = {"flux": maps["flux"] * (1 + 1e-4)}
    assert not cs.sharded_agreement(counts, counts, far, maps)["ok"]
    other = counts.copy()
    other[1, 1] += 1
    res = cs.sharded_agreement(other, counts, maps, maps)
    assert not res["ok"] and not res["counts_equal"]


def test_n_primary_matches_emissivity_normalisation():
    from raytrace_tpu.sources import PointSourceGrid

    g = PointSourceGrid.from_steps(0.05, 0.05)
    assert cs.n_primary(g) == pytest.approx((1.99 / 0.05) * (2 * np.pi / 0.05))


def test_refuses_to_run_off_the_gpu(capsys):
    """On the CPU the script exits nonzero before any phase and prints no
    result line."""
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code != 0
    assert "{" not in capsys.readouterr().out
