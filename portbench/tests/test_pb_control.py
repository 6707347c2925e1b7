"""The control, the reference in bfloat16 put in the program's place,
comes out as not correct under each cell's limits (PERF.md gives its
readings on the card at the cells' own sizes)."""

import pytest

from portbench import control, run
from portbench.tests.conftest import BACKLOG, SEED, tiny

CELLS = [w["name"] for w in run.manifest()["workloads"]] + sorted(BACKLOG)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    files = tiny(workload)
    limits = files["limits"]
    for seed in (SEED, SEED + 1):
        r = control.readings(files, seed, "cpu")
        assert set(r) == set(limits)
        assert any(v > limits[k] for k, v in r.items()), r
