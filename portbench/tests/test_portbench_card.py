"""On the card only: the control (the plain reference computed in TF32 in
the program's place) fails each cell's comparison, at the cell's size."""

import pytest

from portbench import control

CELLS = ["binaural256x-serve-clip10s", "bigvgan22k-vocode-ljs",
         "binaural256x-train-gan-b32"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    for kind, checks in control.control_readings(cell, 2147483011):
        assert any(c["value"] > c["limit"] for c in checks.values()), kind
