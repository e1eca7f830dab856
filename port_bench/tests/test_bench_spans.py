"""The span readers (``port_bench/spans.py`` and the per-layer metrics that
read it) on hand-built traces, and on the program's own spans in a whole
traced run on the CPU."""

from __future__ import annotations

import pytest
from conftest import CpuRun, load

from port_bench import readers, run, spans, trace

SAMPLING = ("unet.idle_ms_per_step.sample", "sampler.idle_ms_per_step.sample",
            "pipeline.idle_ms_per_view.sample", "pipeline.host_syncs_per_batch.sample",
            "spans.unattributed_idle_share.sample")
TRAINING = ("warp.idle_ms_per_step.train", "unet.idle_ms_per_step.train",
            "trainer.host_syncs_per_step.train", "spans.unattributed_idle_share.train")


def _metric(name):
    import os

    path = os.path.join(run.ROOT, "port_bench", "layer_metrics", name + ".py")
    return run.load_file_module(path, "t_spans_" + name.replace(".", "_")).read


def _trace(device, host, window=(0.0, 20.0)):
    return trace.Trace(device, host + [(trace.WINDOW, *window)], window)


def sampling_trace():
    """One batch over [0, 20] s, the device idle over [1, 3], [4, 6],
    [7, 11], [12, 15], [16, 20] (15 s). Forwards [2.5, 8] and [10.5, 13]
    inside steps [2, 10] and [10.5, 14], inside the batch [0.5, 18]: the
    forwards' idle 3.5 + 1.5 s, the steps' own 1 + 2 + 0.5 + 1 s, the
    batch's own 1 + 0.5 + 1 + 2 s, none 2 s ([18, 20])."""
    dev = [("k", 0.0, 1.0), ("k", 3.0, 4.0), ("k", 6.0, 7.0), ("k", 11.0, 12.0),
           ("k", 15.0, 16.0)]
    host = [("pipeline.sample_batch", 0.5, 18.0), ("sampler.step", 2.0, 10.0),
            ("unet.forward", 2.5, 8.0), ("unet.resblock", 2.6, 3.0),
            ("sampler.step", 10.5, 14.0), ("unet.forward", 10.5, 13.0),
            ("aten::add", 9.0, 9.5), ("cudaStreamSynchronize", 9.2, 9.4),
            ("cudaMemcpyAsync", 14.1, 14.2), ("cudaStreamSynchronize", 14.3, 14.9),
            ("cudaDeviceSynchronize", 19.0, 19.5)]
    return _trace(dev, host)


def sampling_facts(tr):
    return {"trace": tr, "traced": {"forwards": [{"count": 1}, {"count": 1}],
                                    "novel_views": 1, "batches": 1}}


def test_self_idle_subtracts_the_child_spans():
    tr = sampling_trace()
    assert spans.idle_s(tr, ["unet.forward"]) == pytest.approx(3.5 + 1.5)
    assert spans.idle_s(tr, ["sampler.step"]) == pytest.approx(8.5)
    assert spans.idle_s(tr, ["sampler.step"], ["unet.forward"]) == pytest.approx(3.5)
    assert spans.idle_s(tr, ["pipeline.sample_batch"], ["sampler.step"]) == \
        pytest.approx(1.0 + 0.5 + 1.0 + 2.0)
    facts = sampling_facts(tr)
    assert _metric("unet.idle_ms_per_step.sample")(facts, None) == pytest.approx(2500.0)
    assert _metric("sampler.idle_ms_per_step.sample")(facts, None) == pytest.approx(1750.0)
    assert _metric("pipeline.idle_ms_per_view.sample")(facts, None) == pytest.approx(4500.0)


def _sampling_partition(facts):
    """The three sampling layers' idle and the unattributed idle, each as a
    share of the traced window, and ``idle_share``'s total."""
    tr = facts["trace"]
    steps = spans.sampler_steps(facts)
    parts = [_metric("unet.idle_ms_per_step.sample")(facts, None) * steps,
             _metric("sampler.idle_ms_per_step.sample")(facts, None) * steps,
             _metric("pipeline.idle_ms_per_view.sample")(facts, None)
             * facts["traced"]["novel_views"]]
    shares = [100.0 * p / 1e3 / tr.window_s for p in parts]
    shares.append(_metric("spans.unattributed_idle_share.sample")(facts, None))
    return shares, readers.idle_percent(facts)


def test_the_sampling_idle_partitions_into_idle_share():
    shares, whole = _sampling_partition(sampling_facts(sampling_trace()))
    assert shares == pytest.approx([25.0, 17.5, 22.5, 10.0])
    assert sum(shares) == pytest.approx(whole)


def test_a_span_started_long_before_a_gap_still_covers_it():
    """Thousands of host operations between a span's start and an idle gap
    (``Trace.idle_gaps`` looks back over 2000) do not hide the span."""
    host = [("pipeline.sample_batch", 0.0, 10.0), ("sampler.step", 0.1, 9.9),
            ("unet.forward", 0.2, 9.8)]
    host += [("cudaLaunchKernel", 0.3 + k * 1e-4, 0.3 + k * 1e-4 + 5e-5) for k in range(5000)]
    dev = [("k", 0.3 + k * 1e-4, 0.3 + k * 1e-4 + 5e-5) for k in range(5000)]
    tr = _trace(dev, host, window=(0.0, 10.0))
    gaps = dict(tr.idle_gaps())
    assert gaps.get("unet.forward", 0.0) < 0.1 and gaps["idle"] > 9.0
    idle = 10.0 - tr.busy_s
    assert spans.idle_s(tr, ["unet.forward"]) == pytest.approx(idle - 0.2 - 0.2)
    assert spans.unattributed_idle_percent(tr) == pytest.approx(0.0)


def test_syncs_count_only_inside_their_span():
    tr = sampling_trace()
    assert spans.syncs(tr, ["pipeline.sample_batch"]) == 2
    assert spans.syncs(tr, ["unet.forward"]) == 0
    assert spans.syncs(tr, ["sampler.step"]) == 1
    facts = sampling_facts(tr)
    assert _metric("pipeline.host_syncs_per_batch.sample")(facts, None) == 2.0
    train = _trace([("k", 0.0, 1.0)],
                   [("trainer.step", 0.5, 5.0), ("trainer.step", 6.0, 9.0),
                    ("cudaStreamSynchronize", 1.0, 1.5), ("cudaEventSynchronize", 6.5, 6.6),
                    ("cudaMemcpy", 8.0, 8.1), ("cudaStreamSynchronize", 5.5, 5.8),
                    ("cudaMemcpyAsync", 2.0, 2.1)], window=(0.0, 10.0))
    assert _metric("trainer.host_syncs_per_step.train")(
        {"trace": train, "traced": {"steps": 2}}, None) == 1.5


def test_training_readers_read_their_stages():
    """The warp's idle under ``trainer.data_and_warp``, the UNet's under the
    forward and backward together, the rest under no span."""
    host = [("trainer.step", 0.0, 10.0), ("trainer.loader_wait", 0.0, 0.5),
            ("trainer.data_and_warp", 0.6, 4.0), ("trainer.forward", 4.0, 6.0),
            ("trainer.backward", 6.0, 8.0), ("trainer.optimizer", 8.0, 9.5)]
    tr = _trace([("k", 1.0, 2.0), ("k", 5.0, 7.0)], host, window=(0.0, 12.0))
    facts = {"trace": tr, "traced": {"steps": 2}}
    assert _metric("warp.idle_ms_per_step.train")(facts, None) == pytest.approx(1200.0)
    assert _metric("unet.idle_ms_per_step.train")(facts, None) == pytest.approx(1000.0)
    assert _metric("spans.unattributed_idle_share.train")(facts, None) == \
        pytest.approx(100.0 * 2.0 / 12.0)


@pytest.mark.parametrize("name", SAMPLING + TRAINING)
def test_each_reader_is_none_without_program_spans(name):
    facts = {"trace": _trace([("k", 1.0, 2.0)], [("aten::add", 1.0, 3.0),
                                                 ("cudaStreamSynchronize", 2.0, 2.5),
                                                 ("port_bench.other", 0.0, 5.0)]),
             "traced": {"forwards": [{"count": 3}], "novel_views": 1, "batches": 1,
                        "steps": 2}}
    assert _metric(name)(facts, None) is None
    assert _metric(name)(dict(facts, trace=None), None) is None


def test_the_manifest_lists_the_readers_by_cell():
    manifest = load("BENCHMARK.json")
    by_name = {m["name"]: m for m in manifest["per_layer"]}
    for names, cells, moves in (
            (SAMPLING, ["in128.sample.random_b8", "sc128.sample.random_b1"], "views_per_s"),
            (TRAINING, ["sc128.train.inpaint_b8"], "train_device_ms_per_image")):
        for name in names:
            m = by_name[name]
            assert (m["source"], m["better"], m["workloads"], m["moves"]) == \
                ("program_span", "lower", cells, moves), name


def test_the_program_spans_of_a_traced_cpu_run():
    """A whole traced run of the tiny sampling cell on the CPU: the
    program's spans are found by the readers, and with no device activity
    every idle second of the window lies in one of the four parts."""
    from port_bench.drivers import sample

    r = CpuRun("sc128.sample.random_b1", trace=True)
    out = sample.run(r)
    facts = out["facts"]
    shares, whole = _sampling_partition(facts)
    assert whole is None  # idle_share reads no window without device activity
    assert sum(shares) == pytest.approx(100.0)
    assert all(s >= 0 for s in shares) and shares[0] > shares[3]
    assert _metric("pipeline.host_syncs_per_batch.sample")(facts, r) == 0.0
