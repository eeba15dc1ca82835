"""On the card: each cell's timed path, at a size a test run holds (its
published widths, fewer plants and steps), comes out correct against the
plain reference, and the bfloat16 control in its place does not. Marked
``gpu``; skips without a card."""

from time import perf_counter

import pytest

from benchmark import controls
from benchmark import run as RUN
from benchmark.harness import cells

SMALL = {"mc4096.b1": dict(plants=256, steps_per_call=720),
         "plant4096.b3": dict(plants=256, steps_per_call=400,
                              record_every=100),
         "plant1.serve3600": dict(steps_per_chunk=360)}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_card_is_correct_and_the_control_is_not(card, workload):
    traffic = dict(cells.cell(workload).traffic, **SMALL[workload])
    result = RUN.run(workload, 2 ** 31 + 5, 1.0, False, device=str(card),
                     traffic=traffic, t_start=perf_counter())
    assert result["correct"], result["checks"]
    got = controls.readings(workload, 2 ** 31 + 6, 0.5, device=str(card),
                            traffic=traffic)
    limits = cells.cell(workload).limits
    assert any(v > limits[k]["limit"] for k, v in got["bfloat16"].items()
               if k in limits)
    assert all(v <= limits[k]["limit"] for k, v in got["program"].items()
               if k in limits)
