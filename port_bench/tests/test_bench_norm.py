"""The GroupNorm readers (``unet.norm_launches_per_forward.sample``,
``unet.norm_roofline.sample``) and their bound (``port_bench.norm_bound``):
the sites of each configuration's UNet, the readers on hand-built traces,
and nothing where the program has no such kernel."""

from __future__ import annotations

import os

import pytest
from conftest import load

from port_bench import norm_bound, peaks, run, trace

KERNEL = "void (anonymous namespace)::gn_act_kernel<__nv_bfloat16, __nv_bfloat16, 1>(Params)"


def _read(name):
    path = os.path.join(run.ROOT, "port_bench", "layer_metrics", name + ".py")
    return run.load_file_module(path, "t_norm_" + name.replace(".", "_")).read


@pytest.mark.parametrize("config,millions", [("sc128", 52.076544), ("in128", 104.153088),
                                             ("in256sr", 208.306176)])
def test_every_unet_has_87_sites(config, millions):
    for model in load("port_bench", "configs", config + ".json")["models"].values():
        sizes = norm_bound.site_elements(model["backbone"]["args"], 1)
        assert len(sizes) == 87
        assert sum(sizes) == pytest.approx(millions * 1e6)
        assert sum(norm_bound.site_elements(model["backbone"]["args"], 3)) == 3 * sum(sizes)


def _facts(kernels, seconds=1e-3, device_kind="NVIDIA H100 80GB HBM3"):
    backbone = load("port_bench", "configs", "sc128.json")["models"]["uncond"]["backbone"]["args"]
    window = (0.0, 10.0)
    device = [(KERNEL, 0.1 * i, 0.1 * i + seconds) for i in range(kernels)]
    device.append(("other", 5.0, 6.0))
    tr = trace.Trace(device, [(trace.WINDOW, *window)], window)
    forwards = [{"backbone": backbone, "batch": 1, "count": 2}]
    return {"trace": tr, "device_kind": device_kind, "traced": {"forwards": forwards}}, backbone


def test_launches_per_traced_forward():
    read = _read("unet.norm_launches_per_forward.sample")
    assert read(_facts(174)[0], None) == pytest.approx(87.0)
    assert read(_facts(0)[0], None) is None
    assert read({"trace": None}, None) is None


def test_roofline_is_the_bytes_bound_over_the_kernel_time():
    read = _read("unet.norm_roofline.sample")
    facts, backbone = _facts(174, seconds=2e-5)
    bound = 2 * 2 * sum(norm_bound.site_elements(backbone, 1)) / peaks.PEAKS["H100"]["bytes"]
    assert read(facts, None) == pytest.approx(100.0 * 2 * bound / (174 * 2e-5))
    assert read(_facts(0)[0], None) is None
    assert read(_facts(174, device_kind="CPU")[0], None) is None
    assert read({"trace": None}, None) is None
