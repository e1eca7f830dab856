"""Sequential uncond→cond multiview RGBD scene generation: the product pipeline.

Port of ``ivid_tpu/inference/pipeline.py:ScenePipeline.sample_batch``. Per
batch of scenes:

1. sample the first view with the unconditional model (full-T DDPM, or
   strided DDIM when ``steps_uncond`` is below T);
2. lift it to a flag-annotated grid mesh (frustum skirt, normals);
3. for each novel view: aggregate the earlier views into an RGBD condition
   (one batched dense-raster launch over all samples' live slots), pack the
   InpaintCFG condition and run guided DDIM with the replace/constrain edits
   (weights 0.1/0.2/0.5), then lift the completed view to a mesh.

Every random draw goes through the noise source passed in (see
:mod:`ivid_tpu_torch.diffusion.noise`), split in the JAX pipeline's order.
On a CUDA device the pipeline records per-stage device time with CUDA events
(:meth:`ScenePipeline.stage_ms`). Under torch.profiler each batch, novel
view and stage is a span (``pipeline.sample_batch``, ``pipeline.view``,
``pipeline.<stage>``; :func:`ivid_tpu_torch.utils.profiling.span`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ivid_tpu_torch.diffusion import samplers
from ivid_tpu_torch.diffusion.samplers import PredX0Edits
from ivid_tpu_torch.ops import geometry as geom
from ivid_tpu_torch.ops import warp as warp_ops
from ivid_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class SceneState:
    """Generated views so far: one stacked mesh ([B, ...] leaves) and one
    color image [B, s, s, 3] in [0, 1] per view, in generation order."""

    meshes: List[geom.Mesh]
    colors: List[torch.Tensor]


def _camera_dirs(mvs: np.ndarray) -> np.ndarray:
    """Unit camera-position directions from [..., 4, 4] view matrices."""
    rot = mvs[..., :3, :3]
    t = mvs[..., :3, 3]
    pos = -np.einsum("...ji,...j->...i", rot, t)
    return pos / np.maximum(np.linalg.norm(pos, axis=-1, keepdims=True), 1e-12)


def select_nearest_views(mvs: np.ndarray, j: int, k: int) -> np.ndarray:
    """Indices [B, k] of the k prior views angularly nearest to view j."""
    dirs = _camera_dirs(mvs)
    sims = np.sum(dirs[:, :j] * dirs[:, j:j + 1], axis=-1)
    return np.ascontiguousarray(np.argsort(-sims, axis=1, kind="stable")[:, :k])


class StageClock:
    """Sums device time per named stage with CUDA events (CUDA only), and
    marks each stage as the span ``{owner}.{name}`` (on any device)."""

    def __init__(self, device: torch.device, owner: str):
        self.enabled = device.type == "cuda"
        self.owner = owner
        self.pairs: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        with span(f"{self.owner}.{name}"):
            if not self.enabled:
                yield
                return
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.pairs.setdefault(name, []).append((start, end))

    def totals(self) -> dict:
        if not self.enabled:
            return {}
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.pairs.items()}


class ScenePipeline:
    """The two frameworks plus the per-view programs. Defaults mirror the
    reference CLI: fov 45, near 0.6, far 5, atol/rtol 0.03, erode_rgb 3,
    guidance 3, SSAA 3."""

    def __init__(self, framework_uncond, framework_cond=None, *, image_size: int = 128,
                 fov: float = 45.0, near: float = 0.6, far: float = 5.0,
                 atol: float = 0.03, rtol: float = 0.03, erode_rgb: int = 3,
                 steps_uncond: int = 1000, steps_cond: int = 50, guidance: float = 3.0,
                 ssaa: int = 3, max_agg_views: Optional[int] = None, device=None):
        self.fw_uncond = framework_uncond
        self.fw_cond = framework_cond
        self.image_size = image_size
        self.fov, self.near, self.far = fov, near, far
        self.atol, self.rtol, self.erode_rgb = atol, rtol, erode_rgb
        self.steps_uncond = steps_uncond
        self.steps_cond = steps_cond
        self.guidance = guidance
        self.ssaa = ssaa
        # Aggregate only the K angularly nearest prior views (None: all).
        self.max_agg_views = max_agg_views
        # Like every other entry point of the port, the card unless the caller
        # names a device.
        self.device = torch.device(device) if device is not None else torch.device("cuda")
        self._clock = StageClock(self.device, "pipeline")

    def stage_ms(self) -> dict:
        """Device milliseconds per stage (uncond, mesh, aggregation, cond)
        summed over the calls so far; empty off CUDA."""
        return self._clock.totals()

    def _run_uncond(self, rng, noise, classes):
        cond = {"classes": classes} if classes is not None else None
        if self.steps_uncond >= self.fw_uncond.schedule.timesteps:
            out = samplers.ddpm_sample(self.fw_uncond, rng, noise=noise, cond=cond,
                                       guidance=self.guidance)
        else:
            out = samplers.ddim_sample(self.fw_uncond, rng, noise=noise, cond=cond,
                                       guidance=self.guidance, steps=self.steps_uncond)
        return out["samples"]

    def _make_meshes(self, rgbd01, modelview) -> geom.Mesh:
        """Batched depth → mesh lift."""
        meshes = [
            geom.depth_to_mesh(
                geom.linearize_depth(x[..., 3:], self.near, self.far),
                padding="frustum", fov=self.fov, modelview=mv, atol=self.atol,
                rtol=self.rtol, erode_rgb=self.erode_rgb, cal_normal=True,
            )
            for x, mv in zip(rgbd01, modelview)
        ]
        return geom.stack_meshes(meshes)

    def _guided_ddim(self, rng, agg, classes):
        color2 = agg["color"] * 2 - 1
        depth2 = agg["depth"] * 2 - 1
        cond = {"y": torch.cat([color2, depth2], dim=-1), "mask": agg["mask"],
                "mask_rgb": agg["mask_rgb"]}
        if classes is not None:
            cond["classes"] = classes
        edits = PredX0Edits(
            replace_rgb=(0.1, color2, agg["mask_rgb"]),
            replace_depth=(0.2, depth2, agg["mask"]),
            constrain_depth=(0.5, agg["depth_convex"] * 2 - 1),
        )
        out = samplers.ddim_sample(
            self.fw_cond, rng, num=agg["color"].shape[0], image_size=self.image_size,
            cond=cond, guidance=self.guidance, steps=self.steps_cond, edits=edits,
        )
        return out["samples"]

    def _add_view(self, state: SceneState, rgbd01, modelview) -> None:
        with self._clock("mesh"):
            state.meshes.append(self._make_meshes(rgbd01, modelview))
        state.colors.append(rgbd01[..., :3])

    @torch.no_grad()
    def sample_batch(self, rng, modelviews, *, batch: int,
                     classes: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None):
        """Generate one batch of scenes over a viewset. ``rng`` is a noise
        source; ``modelviews`` [V,4,4] (shared) or [B,V,4,4] (per sample).
        Returns (state, samples [B, V, s, s, 4] in [-1, 1], conds dict with
        ``color``/``depth`` [B, V-1, s, s, ·] in [-1, 1], or None)."""
        with span("pipeline.sample_batch"):
            s = self.image_size
            dev = self.device
            mvs_host = np.asarray(modelviews, np.float32)
            if mvs_host.ndim == 3:
                mvs_host = np.broadcast_to(mvs_host[None], (batch,) + mvs_host.shape)
            mvs = torch.from_numpy(np.array(mvs_host)).to(dev)
            n_views = mvs.shape[1]

            rng, r0 = rng.split()
            if noise is None:
                rng, rn = rng.split()
                noise = rn.normal((batch, s, s, 4))
            noise = noise.to(dev)
            with self._clock("uncond"):
                x0 = self._run_uncond(r0, noise, classes)
            samples = [x0]
            conds = {"color": [], "depth": []}
            state = SceneState(meshes=[], colors=[])
            self._add_view(state, x0 * 0.5 + 0.5, mvs[:, 0])

            cap = self.max_agg_views
            for j in range(1, n_views):
                with span("pipeline.view"):
                    rng, rj = rng.split()
                    if cap is not None and j > cap:
                        idx = torch.from_numpy(select_nearest_views(mvs_host, j, cap)).to(dev)
                        bi = torch.arange(batch, device=dev)[:, None]
                        stacked = geom.stack_meshes(state.meshes, dim=1)
                        meshes_j = stacked.map(lambda x: x[bi, idx])
                        colors_j = torch.stack(state.colors, dim=1)[bi, idx]
                    else:
                        meshes_j = geom.stack_meshes(state.meshes, dim=1)
                        colors_j = torch.stack(state.colors, dim=1)
                    with self._clock("aggregation"):
                        agg = warp_ops.aggregate_conditions_batch(
                            meshes_j, colors_j, mvs[:, j], fov=self.fov, near=self.near,
                            far=self.far, atol=self.atol, rtol=self.rtol,
                            erode_rgb=self.erode_rgb, ssaa=self.ssaa,
                        )
                    with self._clock("cond"):
                        xj = self._guided_ddim(rj, agg, classes)
                    samples.append(xj)
                    conds["color"].append(agg["color"] * 2 - 1)
                    conds["depth"].append(agg["depth"] * 2 - 1)
                    self._add_view(state, xj * 0.5 + 0.5, mvs[:, j])

            samples = torch.stack(samples, dim=1)
            conds_out = ({k: torch.stack(v, dim=1) for k, v in conds.items()}
                         if conds["color"] else None)
            return state, samples, conds_out

    @staticmethod
    def state_to_host_scene(state: SceneState, sample_idx: int, n_views: int):
        """One sample's meshes/colors as host numpy for scene IO."""
        meshes, colors = [], []
        for v in range(n_views):
            meshes.append(state.meshes[v].map(lambda x: x[sample_idx].cpu().numpy()))
            colors.append(state.colors[v][sample_idx].cpu().numpy())
        return meshes, colors
