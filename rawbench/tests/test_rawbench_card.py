"""On the card: the control (the reference rounded to bfloat16 between
stages, in the program's place) fails each cell's check on three seeds
at the cell's own size and load, and the program passes it on the same
seeds.  Run on the card with `python -m pytest rawbench/tests -m card`."""

import pytest

pytestmark = pytest.mark.card


@pytest.mark.parametrize("workload", ["develop24.roll", "heavy45.roll",
                                      "develop24.sets"])
def test_control_fails_and_program_passes(workload, card):
    from rawbench import control, harness

    cfg = harness.load_config(harness.cell_of(harness.load_bench(),
                                              workload)[1])
    limit = cfg["limits"]["max_gap"]
    got = control.readings(workload, [7, 8, 9], [7, 8, 9], 3.0,
                           device=card, emit=lambda s: None)
    assert max(got["program"]) <= limit
    assert min(got["control"]) > limit
