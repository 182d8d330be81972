"""On the card: each cell's control (its limits file names it: the
reference with every float32 product in TF32 and a float32 eigen-solver),
put in the program's place, comes out not correct against the cell's
limits, while the program comes out correct.  At a size a test run holds:
the cell's widths over 4 lanes and 16 scans (the scans compared point by
point end at 12)."""

import json
import os
import types

import pytest

import tiny
from harness import compare, readings, spec

pytestmark = pytest.mark.cuda

CELLS = ("flagship-fleet-b16", "flagship-one-seq", "faithful-fleet-b16")


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_holds(card, name):
    full = spec.load(name)
    tr = dict(full.traffic, lanes=min(4, full.traffic["lanes"]), scans=16)
    cell = types.SimpleNamespace(name=name, chips=1, config=full.config,
                                 traffic=tr)
    with open(os.path.join(tiny.BENCH, "limits", name + ".json")) as f:
        given = json.load(f)
    limits = {k: v for k, v in given.items()
              if k not in ("about", "control")}
    r = readings.readings(cell, 2 ** 31 + 101, card, [given["control"]])
    assert compare.verdict(r["program"], limits)[0], r["program"]
    assert not compare.verdict(r[given["control"]], limits)[0], r
