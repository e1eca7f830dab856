"""The residual-sum reader (``unet.residual_launches_per_forward.sample``) on
hand-built traces: launches of ``bias_residual_`` kernels per traced
forward, and nothing where the program has no such kernel."""

from __future__ import annotations

import os

import pytest

from port_bench import run, trace

KERNEL = "void (anonymous namespace)::bias_residual_kernel<__nv_bfloat16>(Params)"
NORM = "void (anonymous namespace)::gn_act_kernel<__nv_bfloat16, __nv_bfloat16, 2>(Params)"


def _read(name):
    path = os.path.join(run.ROOT, "port_bench", "layer_metrics", name + ".py")
    return run.load_file_module(path, "t_res_" + name.replace(".", "_")).read


def _facts(kernels, norms=0):
    window = (0.0, 10.0)
    device = [(KERNEL, 0.01 * i, 0.01 * i + 1e-3) for i in range(kernels)]
    device += [(NORM, 5.0 + 0.01 * i, 5.0 + 0.01 * i + 1e-3) for i in range(norms)]
    device.append(("other", 8.0, 9.0))
    tr = trace.Trace(device, [(trace.WINDOW, *window)], window)
    return {"trace": tr, "traced": {"forwards": [{"batch": 1, "count": 2}]}}


def test_launches_per_traced_forward():
    read = _read("unet.residual_launches_per_forward.sample")
    assert read(_facts(70, norms=174), None) == pytest.approx(35.0)
    assert read(_facts(0, norms=174), None) is None
    assert read({"trace": None}, None) is None


def test_the_norm_reader_does_not_count_the_residual_kernel():
    read = _read("unet.norm_launches_per_forward.sample")
    assert read(_facts(70, norms=174), None) == pytest.approx(87.0)
