"""A run with the timed path broken underneath comes out not correct:
one planted fault at a time (``portbench_faults``), on the CPU at small
sizes; ``test_portbench_card.py`` plants them at the cells' own sizes."""
import pytest

from portbench.tests.portbench_faults import FAULTS
from portbench.tests.portbench_tiny import TINY, tiny_run


@pytest.mark.parametrize("family", sorted(TINY))
def test_a_sound_run_is_correct(family):
    result, checks, _ = tiny_run(family)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("family", sorted(TINY))
def test_a_planted_fault_is_not_correct(family, fault):
    result, checks, _ = tiny_run(family, inject=FAULTS[fault])
    assert not result["correct"], checks
    assert checks["max_logit_gap"][0] > checks["max_logit_gap"][1]
