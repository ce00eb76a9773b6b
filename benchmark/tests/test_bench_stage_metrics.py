"""The readers of the detect call's stages (metrics/route_share.detect.py,
drain_share, call_overhead_share, unnamed_share) on a synthetic record:
each main-thread stage's seconds over the window's wall, in %, and nothing
where the record holds no stages or the program lacks the stage."""

import pytest

from harness import core

MAIN = {"detect": 0.4, "open": 0.2, "steps": 0.6, "route": 1.5, "drain": 2.5, "close": 0.2,
        "parse": 3.0, "write": 1.0}
WANT = {"route_share.detect": 15.0, "drain_share.detect": 25.0,
        "call_overhead_share.detect": 10.0, "unnamed_share.detect": 4.0}


def read(name, rec):
    return core.load_module("metrics", name).read(rec)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_stages(name):
    rec = {"wall_s": 10.0, "stages": {"main": dict(MAIN), "worker": {}}}
    assert read(name, rec) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_without_the_stages(name):
    # an untraced run keeps no stages; a program without these stages (one
    # older than them) reads the rest only
    assert read(name, {"wall_s": 10.0, "stages": None}) is None
    old = {k: v for k, v in MAIN.items() if k in ("parse", "write")}
    assert read(name, {"wall_s": 10.0, "stages": {"main": old, "worker": {}}}) is None
