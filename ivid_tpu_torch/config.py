"""Config system: the reference's 4-section JSON schema (``backbone`` /
``framework`` / ``dataset`` / ``trainer``, each ``{name, args}``), resolved
through explicit registries. Port of ``ivid_tpu/config.py``; reads the same
``configs/*.json`` files."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch


@dataclass
class Config:
    backbone: Dict[str, Any]
    framework: Dict[str, Any]
    dataset: Dict[str, Any] = field(default_factory=dict)
    trainer: Dict[str, Any] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        known = {k: raw[k] for k in ("backbone", "framework", "dataset", "trainer") if k in raw}
        extra = {k: v for k, v in raw.items() if k not in known}
        return cls(**known, extra=extra)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"backbone": self.backbone, "framework": self.framework,
                       "dataset": self.dataset, "trainer": self.trainer, **self.extra},
                      f, indent=4)

    def resolve_num_classes(self, num_classes: Optional[int]) -> None:
        """Resolve the backbone's ``num_classes: "auto"`` from the dataset."""
        if self.backbone.get("args", {}).get("num_classes") == "auto":
            self.backbone["args"]["num_classes"] = num_classes


def build_backbone(cfg: Config, dtype: Optional[torch.dtype] = None):
    """The backbone module of ``cfg``; ``dtype`` overrides the torso type that
    ``use_fp16`` selects (bf16 when set, else f32)."""
    from ivid_tpu_torch.models.adm import BACKBONES

    section = cfg.backbone
    return BACKBONES[section["name"]](section.get("args", {}), dtype=dtype)


def build_framework_from_config(cfg: Config, model, device=None):
    from ivid_tpu_torch.diffusion.frameworks import build_framework

    section = cfg.framework
    return build_framework(section["name"], model, section.get("args", {}), device=device)
