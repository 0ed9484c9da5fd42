"""The comparison that decides `correct` fails where it must: the
lower-precision control in the program's place, and each fault a cell
can have planted underneath the timed path (a step that returns its
state or answer unchanged, half of the batch left out, an answer
altered where it is produced).  The harness's look for a card is
skipped; the rest of a run is driven on the CPU at a tiny size."""

import pytest

from gnssbench.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell,how", [
    ("gps-l1.acquire", ["--control", "tf32-reference"]),
    ("gps-l1.track", ["--control", "float32-sums"]),
    ("sky2017.receiver", ["--control", "float32-sums"]),
])
def test_control_is_not_correct(bench, cell, how):
    rc, out = tiny.run(bench, cell, *how)
    assert rc == 0
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", ["gps-l1.acquire", "gps-l1.track",
                                  "sky2017.receiver"])
@pytest.mark.parametrize("fault", ["stale", "half", "alter"])
def test_fault_is_not_correct(bench, cell, fault):
    rc, out = tiny.run(bench, cell, "--fault", fault)
    assert rc == 0
    assert out["correct"] is False, out["checks"]
