"""The yardstick's tables: FLOPs of the reference UNet, parameter counts,
the attention bound, the sites the port runs through its kernel, the
peaks."""

from __future__ import annotations

import pytest
import torch
from conftest import load

from port_bench import attention_bound, flops, peaks, weights

H100 = peaks.peaks("NVIDIA H100 80GB HBM3")

# GFLOP per image (meta device, torch.utils.flop_counter) and millions of
# parameters of the four published models.
PUBLISHED = {
    ("sc128", "uncond"): (156.6, 105.2),
    ("sc128", "cond"): (156.8, 105.2),
    ("in128", "uncond"): (613.8, 421.5),
    ("in128", "cond"): (614.2, 421.5),
}


@pytest.mark.parametrize("config,role", sorted(PUBLISHED))
def test_forward_flops_and_parameters(config, role):
    args = load("port_bench", "configs", config + ".json")["models"][role]["backbone"]["args"]
    gflop, mparams = PUBLISHED[(config, role)]
    assert round(flops.forward_flops(args, 1) / 1e9, 1) == gflop
    assert flops.forward_flops(args, 16) == 16 * flops.forward_flops(args, 1)
    n = sum(int(torch.Size(s).numel()) for _, s, _ in weights.layout(args))
    assert round(n / 1e6, 1) == mparams


def test_flops_match_the_program_count():
    """The port's own counter (``utils/summary.forward_flops``) counts the
    same FLOPs on its UNet."""
    from ivid_tpu_torch.config import Config, build_backbone
    from ivid_tpu_torch.utils.summary import forward_flops

    cfg = load("port_bench", "configs", "sc128.json")["models"]["cond"]
    args = cfg["backbone"]["args"]
    with torch.device("meta"):
        model = build_backbone(Config(backbone=cfg["backbone"], framework=cfg["framework"]))
    x = torch.empty((2, 128, 128, args["in_channels"]))
    t = torch.zeros((2,), dtype=torch.long)
    assert forward_flops(model, [x, t]) == flops.forward_flops(args, 2)


# bench_attention.bound_ms's values as PERF.md's kernel table gives them (ms).
BOUNDS = [
    ((8, 1024, 4), "bf16", False, 0.0087),
    ((2, 1024, 4), "bf16", False, 0.0022),
    ((2, 1024, 4), "f32", False, 0.0130),
    ((8, 1024, 4), "f32", False, 0.0521),
    ((20, 1024, 8), "f32", False, 0.2605),
    ((16, 1024, 8), "f32", False, 0.2084),
    ((8, 1024, 4), "bf16", True, 0.0217),
    ((2, 1024, 4), "f32", True, 0.0326),
    ((8, 1024, 4), "f32", True, 0.1302),
    ((16, 1024, 8), "f32", True, 0.5209),
]


@pytest.mark.parametrize("shape,dtype,backward,ms", BOUNDS)
def test_attention_bound(shape, dtype, backward, ms):
    s, by = attention_bound.bound_s(*shape, dtype, H100, backward)
    assert round(s * 1e3, 4) == ms
    assert by == "operations"


@pytest.mark.parametrize("config,heads", [("sc128", 4), ("in128", 8)])
def test_kernel_sites(config, heads):
    """Five attention sites at 32x32 (1024 tokens) go through K1 in a
    forward; the 16x16 and 8x8 sites take the plain form."""
    for model in load("port_bench", "configs", config + ".json")["models"].values():
        assert attention_bound.kernel_sites(model["backbone"]["args"]) == [(1024, heads)] * 5


def test_peaks():
    assert H100["bf16_flops"] == 989e12 and H100["tf32_flops"] == 494.7e12
    assert peaks.peaks("cpu") is None
