"""The reader of ``unet.graph_replays_per_forward.sample`` on hand-built
traces: the ``unet.graph_replay`` spans over the traced forwards, and
nothing where the program has no such span."""

from __future__ import annotations

import os

import pytest

from port_bench import run, trace

NAME = "unet.graph_replays_per_forward.sample"


def _read():
    path = os.path.join(run.ROOT, "port_bench", "layer_metrics", NAME + ".py")
    return run.load_file_module(path, "t_graph_" + NAME.replace(".", "_")).read


def _facts(host, forwards=(2, 1)):
    window = (0.0, 10.0)
    tr = trace.Trace([("k", 0.0, 1.0)], host + [(trace.WINDOW, *window)], window)
    return {"trace": tr, "traced": {"forwards": [{"count": n} for n in forwards]}}


@pytest.mark.parametrize("replays,want", [(3, 1.0), (2, 2 / 3), (0, None)])
def test_replays_per_traced_forward(replays, want):
    host = [("unet.forward", 1.0 + i, 1.5 + i) for i in range(3)]
    host += [("unet.graph_replay", 1.1 + i, 1.4 + i) for i in range(replays)]
    got = _read()(_facts(host), None)
    assert got == (None if want is None else pytest.approx(want))


def test_no_trace_reads_nothing():
    assert _read()({"trace": None}, None) is None
    assert _read()({}, None) is None
