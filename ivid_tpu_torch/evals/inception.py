"""FID-edition InceptionV3 feature extractor.

Port of ``ivid_tpu/evals/inception.py``: the compute graph of the
pytorch-fid / torch-fidelity InceptionV3 port of the TF
"inception-2015-12-05" network, the network behind published FID numbers,
as an ``nn.Module`` whose state_dict keys are :func:`expected_keys` (the
torch-fidelity weights file's own, ``fc`` → 1008 classes). The weights are
not in the repository: a file is given at run time
(``--extractor inception:<path>``).

FID-edition quirks kept (they differ from torchvision's InceptionV3 and
change FID values):

- every in-block average pool uses ``count_include_pad=False``;
- ``Mixed_7c`` (the second InceptionE) uses a MAX pool in its pool branch;
- the input is resized to 299² by TF1's origin-aligned bilinear
  (:func:`resize_tf1`, not ``F.interpolate``) and scaled by
  ``(255·x − 128)/128`` for [0,1] inputs;
- BatchNorm eps 1e-3, convs bias-free; the logits leave out the fc bias
  (torch-fidelity's ``logits_unbiased``, which its inception score reads).

Features are the 2048-d global-average-pool activations.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# ------------------------------------------------------------------ blocks
# Each BasicConv2d is (name, out_ch, (kh, kw), stride, (ph, pw)).


def _inception_a(pool_features: int):
    return {
        "branch1x1": [("branch1x1", 64, (1, 1), 1, (0, 0))],
        "branch5x5": [
            ("branch5x5_1", 48, (1, 1), 1, (0, 0)),
            ("branch5x5_2", 64, (5, 5), 1, (2, 2)),
        ],
        "branch3x3dbl": [
            ("branch3x3dbl_1", 64, (1, 1), 1, (0, 0)),
            ("branch3x3dbl_2", 96, (3, 3), 1, (1, 1)),
            ("branch3x3dbl_3", 96, (3, 3), 1, (1, 1)),
        ],
        "pool": ("avg", [("branch_pool", pool_features, (1, 1), 1, (0, 0))]),
    }


def _inception_b():
    return {
        "branch3x3": [("branch3x3", 384, (3, 3), 2, (0, 0))],
        "branch3x3dbl": [
            ("branch3x3dbl_1", 64, (1, 1), 1, (0, 0)),
            ("branch3x3dbl_2", 96, (3, 3), 1, (1, 1)),
            ("branch3x3dbl_3", 96, (3, 3), 2, (0, 0)),
        ],
        "pool": ("maxpool_s2", []),
    }


def _inception_c(c7: int):
    return {
        "branch1x1": [("branch1x1", 192, (1, 1), 1, (0, 0))],
        "branch7x7": [
            ("branch7x7_1", c7, (1, 1), 1, (0, 0)),
            ("branch7x7_2", c7, (1, 7), 1, (0, 3)),
            ("branch7x7_3", 192, (7, 1), 1, (3, 0)),
        ],
        "branch7x7dbl": [
            ("branch7x7dbl_1", c7, (1, 1), 1, (0, 0)),
            ("branch7x7dbl_2", c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_3", c7, (1, 7), 1, (0, 3)),
            ("branch7x7dbl_4", c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_5", 192, (1, 7), 1, (0, 3)),
        ],
        "pool": ("avg", [("branch_pool", 192, (1, 1), 1, (0, 0))]),
    }


def _inception_d():
    return {
        "branch3x3": [
            ("branch3x3_1", 192, (1, 1), 1, (0, 0)),
            ("branch3x3_2", 320, (3, 3), 2, (0, 0)),
        ],
        "branch7x7x3": [
            ("branch7x7x3_1", 192, (1, 1), 1, (0, 0)),
            ("branch7x7x3_2", 192, (1, 7), 1, (0, 3)),
            ("branch7x7x3_3", 192, (7, 1), 1, (3, 0)),
            ("branch7x7x3_4", 192, (3, 3), 2, (0, 0)),
        ],
        "pool": ("maxpool_s2", []),
    }


def _inception_e(pool_mode: str):
    # branch3x3 / branch3x3dbl fan out into concatenated (1,3)+(3,1) pairs.
    return {
        "branch1x1": [("branch1x1", 320, (1, 1), 1, (0, 0))],
        "branch3x3_split": (
            [("branch3x3_1", 384, (1, 1), 1, (0, 0))],
            [("branch3x3_2a", 384, (1, 3), 1, (0, 1))],
            [("branch3x3_2b", 384, (3, 1), 1, (1, 0))],
        ),
        "branch3x3dbl_split": (
            [
                ("branch3x3dbl_1", 448, (1, 1), 1, (0, 0)),
                ("branch3x3dbl_2", 384, (3, 3), 1, (1, 1)),
            ],
            [("branch3x3dbl_3a", 384, (1, 3), 1, (0, 1))],
            [("branch3x3dbl_3b", 384, (3, 1), 1, (1, 0))],
        ),
        "pool": (pool_mode, [("branch_pool", 192, (1, 1), 1, (0, 0))]),
    }


STEM = [
    ("Conv2d_1a_3x3", 32, (3, 3), 2, (0, 0)),
    ("Conv2d_2a_3x3", 32, (3, 3), 1, (0, 0)),
    ("Conv2d_2b_3x3", 64, (3, 3), 1, (1, 1)),
    ("maxpool", None, None, None, None),
    ("Conv2d_3b_1x1", 80, (1, 1), 1, (0, 0)),
    ("Conv2d_4a_3x3", 192, (3, 3), 1, (0, 0)),
    ("maxpool", None, None, None, None),
]

MIXED = [
    ("Mixed_5b", _inception_a(32)),
    ("Mixed_5c", _inception_a(64)),
    ("Mixed_5d", _inception_a(64)),
    ("Mixed_6a", _inception_b()),
    ("Mixed_6b", _inception_c(128)),
    ("Mixed_6c", _inception_c(160)),
    ("Mixed_6d", _inception_c(160)),
    ("Mixed_6e", _inception_c(192)),
    ("Mixed_7a", _inception_d()),
    ("Mixed_7b", _inception_e("avg")),
    ("Mixed_7c", _inception_e("max")),  # the TF-port quirk: max, not avg
]

FEATURE_DIM = 2048
LOGIT_DIM = 1008


def expected_keys() -> list:
    """All torch state_dict keys of the FID Inception, in module order."""
    return list(InceptionV3().state_dict())


def convert_state_dict(sd: Dict[str, "torch.Tensor"]) -> Dict[str, torch.Tensor]:
    """The float32 CPU tensors of ``sd`` (a torch-fidelity state_dict, numpy
    arrays or tensors) at :func:`expected_keys`, in torch layouts; extra
    keys (``num_batches_tracked``) are dropped."""
    out = {}
    for k in expected_keys():
        v = sd[k]
        v = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out[k] = v.float().contiguous()
    return out


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """A weights file's state_dict, with torch-fidelity's prefixes
    stripped, through :func:`convert_state_dict`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if not any(k.startswith("Conv2d_1a_3x3") for k in sd):
        for prefix in ("model.", "inception.", "module."):
            if any(k.startswith(prefix + "Conv2d_1a_3x3") for k in sd):
                sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
                break
    return convert_state_dict(sd)


# ------------------------------------------------------------------ modules


class _BatchNorm(nn.Module):
    """Inference BatchNorm (eps 1e-3) with exactly the four state_dict
    entries of the weights file (no ``num_batches_tracked``)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-3)


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int, padding):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = _BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def maxpool(x: torch.Tensor, stride: int, pad: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=stride, padding=pad)


def avgpool_nopad(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 pad-1 average pool with count_include_pad=False."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def resize_tf1(x: torch.Tensor, out: int = 299) -> torch.Tensor:
    """Origin-aligned bilinear resize of NHWC ``x`` to ``out``² (TF1
    ``resize_bilinear`` with ``align_corners=False``: src = dst * in/out,
    NO half-pixel offset): the kernel torch-fidelity uses
    (interpolate_bilinear_2d_like_tensorflow1x). ``F.interpolate``'s
    half-pixel convention (pytorch-fid's) shifts every feature slightly."""
    h, w = x.shape[1], x.shape[2]

    def axis(n_in):
        coords = torch.arange(out, dtype=torch.float32, device=x.device) * np.float32(n_in / out)
        lo = torch.floor(coords).long()
        hi = torch.clamp(lo + 1, max=n_in - 1)
        return lo, hi, coords - lo

    ylo, yhi, ty = axis(h)
    xlo, xhi, tx = axis(w)
    tx = tx[None, None, :, None]
    ty = ty[None, :, None, None]
    top = x[:, ylo][:, :, xlo] * (1 - tx) + x[:, ylo][:, :, xhi] * tx
    bot = x[:, yhi][:, :, xlo] * (1 - tx) + x[:, yhi][:, :, xhi] * tx
    return top * (1 - ty) + bot * ty


def _chain(parent: nn.Module, convs, cin: int):
    for name, cout, k, s, p in convs:
        parent.add_module(name, BasicConv2d(cin, cout, k, s, p))
        cin = cout
    return cin


class Mixed(nn.Module):
    """One Inception block from its spec (see :data:`MIXED`)."""

    def __init__(self, block: dict, cin: int):
        super().__init__()
        self.block = block
        self.out_channels = 0
        for bname, spec in block.items():
            if bname == "pool":
                mode, convs = spec
                self.out_channels += _chain(self, convs, cin) if convs else cin
            elif bname.endswith("_split"):
                trunk, a, b = spec
                mid = _chain(self, trunk, cin)
                self.out_channels += _chain(self, a, mid) + _chain(self, b, mid)
            else:
                self.out_channels += _chain(self, spec, cin)

    def _run(self, convs, x):
        for conv in convs:
            x = getattr(self, conv[0])(x)
        return x

    def forward(self, x):
        outs = []
        for bname, spec in self.block.items():
            if bname == "pool":
                mode, convs = spec
                if mode == "avg":
                    y = avgpool_nopad(x)
                elif mode == "max":
                    y = maxpool(x, 1, pad=1)
                else:  # maxpool_s2: bare stride-2 max pool branch
                    y = maxpool(x, 2)
                y = self._run(convs, y)
            elif bname.endswith("_split"):
                trunk, a, b = spec
                y0 = self._run(trunk, x)
                y = torch.cat([self._run(a, y0), self._run(b, y0)], dim=1)
            else:
                y = self._run(spec, x)
            outs.append(y)
        return torch.cat(outs, dim=1)


class InceptionV3(nn.Module):
    """The FID InceptionV3; ``forward`` maps NHWC images in [0,1] to
    (features [B,2048], unbiased logits [B,1008])."""

    def __init__(self):
        super().__init__()
        cin = 3
        for name, cout, k, s, p in STEM:
            if name != "maxpool":
                self.add_module(name, BasicConv2d(cin, cout, k, s, p))
                cin = cout
        for mname, block in MIXED:
            m = Mixed(block, cin)
            self.add_module(mname, m)
            cin = m.out_channels
        self.fc = nn.Linear(FEATURE_DIM, LOGIT_DIM)

    def forward(self, imgs: torch.Tensor):
        x = resize_tf1(imgs).permute(0, 3, 1, 2)
        x = (x * 255.0 - 128.0) / 128.0
        for name, *_ in STEM:
            x = maxpool(x, 2) if name == "maxpool" else getattr(self, name)(x)
        for mname, _ in MIXED:
            x = getattr(self, mname)(x)
        feats = x.mean(dim=(2, 3))
        return feats, feats @ self.fc.weight.T


def seeded_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A state_dict at :func:`expected_keys` drawn with numpy from ``seed``
    (He-scaled convolutions, BatchNorm statistics near identity): stands in
    for the weights file in tests and smoke runs."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in InceptionV3().state_dict().items():
        if k.endswith("conv.weight"):
            fan_in = int(np.prod(v.shape[1:]))
            a = rng.standard_normal(v.shape) * np.sqrt(2.0 / fan_in)
        elif k.endswith("running_mean"):
            a = rng.normal(0, 0.05, v.shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("bn.weight"):
            a = rng.uniform(0.8, 1.2, v.shape)
        elif k.endswith("bn.bias"):
            a = rng.normal(0, 0.05, v.shape)
        else:  # fc
            a = rng.standard_normal(v.shape) / np.sqrt(v.shape[-1])
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


class InceptionFeatures:
    """Callable extractor: images [N,H,W,3] in [0,1] → (feats, logits),
    on ``device``, in float32 without TF32."""

    feature_dim = FEATURE_DIM
    logit_dim = LOGIT_DIM

    def __init__(self, weights_path: str, device="cuda"):
        self.device = torch.device(device)
        self.model = InceptionV3().eval()
        self.model.load_state_dict(load_torch_weights(weights_path))
        self.model.to(self.device)

    def __call__(self, images: np.ndarray, batch: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        from ivid_tpu_torch.evals.metrics import run_batches

        return run_batches(self.model, images, self.device, batch)
