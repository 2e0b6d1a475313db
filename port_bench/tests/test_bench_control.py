"""The control at a size a test run holds: the reference computed in fp8
(e4m3), put in the program's place, reads past a tiny cell's limits where
the program reads within them; so does each planted fault.  On the card
the same readings at each cell's own size set its limits
(``port_bench/control.py``)."""

import pytest
import torch

from conftest import RESNET, VANILLA, tiny_cell
from port_bench import control


@pytest.mark.parametrize("config", [VANILLA, RESNET],
                         ids=["vanilla", "resnet"])
def test_control_fails_where_program_passes(config):
    cell = tiny_cell(config)
    rows = {r["side"]: r for r in control.readings(
        cell, 11, True, torch.device("cpu"))}
    assert set(rows) == {"program", "control_fp8"} | {
        f"fault_{f}" for f in control.FAULTS}
    limits = cell["limits"]
    assert all(rows["program"][k] <= v for k, v in limits.items())
    for side, row in rows.items():
        if side != "program":
            assert any(row[k] > v for k, v in limits.items()), side
