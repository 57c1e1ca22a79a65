"""The precision control: the plain reference in bfloat16, put in the
program's place, fails the limits that the program passes."""

import json

import pytest

from benchmark import control
from benchmark.tests.conftest import ROOT, SMALL


def limits(workload):
    return json.loads((ROOT / "benchmark" / "limits" / f"{workload}.json").read_text())


def fails(readings, lim):
    return [k for k, v in lim.items() if readings.get(k, 0.0) > v]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_and_program_passes_small(bench, workload):
    r = control.readings(bench, workload, 2**31 + 21, 0.5, "cpu", overrides=SMALL[workload])
    lim = limits(workload)
    assert not fails(r["program"], lim), r["program"]
    assert fails(r["control"], lim), r["control"]


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_at_cell_size(bench, cuda_card, workload):
    """At the cell's own size on the card, three seeds."""
    lim = limits(workload)
    for seed in (2**31 + 31, 32, 33):
        r = control.readings(bench, workload, seed, 2.0, cuda_card)
        assert not fails(r["program"], lim), r["program"]
        assert fails(r["control"], lim), r["control"]
