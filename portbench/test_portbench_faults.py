"""``correct`` comes out false when the timed path is broken underneath, and
the control (the reference in binary8 weights) fails the limit: a whole
run of the tiny cell on the CPU, past the look for a card.  The cell has
one chip, so no exchange between chips can be left out."""
import pytest

from portbench import faults, harness
from portbench.conftest import TINY_LIMIT, tiny_cell


def run(tree, seed=11, **kw):
    return harness.run_cell(tiny_cell(tree), seed, 0.15, False, device="cpu",
                            say=lambda m: None, **kw)


def test_a_sound_run_is_correct(tiny_tree):
    res = run(tiny_tree)
    assert res["correct"] is True
    assert res["checks"]["logit_gap"]["value"] <= TINY_LIMIT


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_tree, monkeypatch, fault):
    faults.plant(fault, monkeypatch.setattr)
    res = run(tiny_tree)
    assert res["correct"] is False
    assert res["checks"]["logit_gap"]["value"] > TINY_LIMIT


@pytest.mark.parametrize("seed", [21, 2**31 + 3, 987654321])
def test_the_control_fails_the_limit(tiny_tree, seed):
    res = run(tiny_tree, seed, others={"control": {"weight_fmt": "e5m2"}})
    assert res["checks"]["logit_gap"]["value"] <= TINY_LIMIT
    assert res["other_gaps"]["control"] > TINY_LIMIT
    # the harness's own checks, with the control's gap in the program's
    # place, say not correct
    assert harness.correct(harness.checks_with(res, "control")) is False
