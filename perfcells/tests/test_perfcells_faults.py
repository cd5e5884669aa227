"""The check fails where it must: a run with the timed path broken
underneath, and the control (the reference one precision down, TF32, in the
program's place), each come out not correct."""

import pytest

import perfcells_tiny as tiny

CASES = [("c3-population-train", "hooks.fault", "frozen"),
         ("c3-population-train", "hooks.fault", "frozen_lane"),
         ("c3-population-train", "hooks.fault", "half_batch"),
         ("c3-population-train", "hooks.control", "tf32"),
         ("c4-serve-poisson", "hooks.fault", "altered"),
         ("c4-serve-poisson", "hooks.fault", "half_batch"),
         ("c4-serve-poisson", "hooks.control", "tf32"),
         ("c4-serve-poisson", "hooks.control", "frozen")]


@pytest.mark.parametrize("cell,key,value", CASES)
def test_broken_run_is_not_correct(cell, key, value):
    result, checks = tiny.run(cell, **{key: value})
    assert result["correct"] is False, checks.line()


def test_one_frozen_lane_is_caught_by_the_worst_lane():
    """Four sound lanes of five hide the fifth from the median over lanes;
    the worst lane's median leaf shows it."""
    result, checks = tiny.run("c3-population-train", **{"hooks.fault": "frozen_lane",
                                                        "config.population": 5})
    assert result["correct"] is False
    v, lim = checks.values, checks.limits
    assert v["change_gap"] <= lim["change_gap"] < v["change_lane_gap"]
    assert v["ema_gap"] <= lim["ema_gap"] < v["ema_lane_gap"]
