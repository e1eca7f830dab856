"""Time the attention kernels K1 and K4 on the card, optionally beside another
version of their sources:

    python -m ivid_tpu_torch.bench_attention [--other DIR]

Shapes (4 heads of 64, scale 64^-1/4, bf16, seeded inputs): K1 at
[2, 1024, 768] (sampling) and, with the log-sum-exp, at [8, 1024, 768]
(training); K4 at [2, 1024, 768] and [8, 1024, 768]. Beside each, torch's
scaled_dot_product_attention (forward, or its backward through autograd) on
the same inputs unpacked, and the bound of ``chip_smoke.py``.

With ``--other DIR``, ``DIR/packed_attention.cu`` and
``DIR/packed_attention_bwd.cu`` are built too (the same C entry points, for
example an earlier commit's sources unpacked with ``git archive``) and the
two versions run in turns (other, this, this, other) on the same inputs.
Each number is device time from torch.profiler with CUDA events beside it
(``ivid_tpu_torch.timing``). Prints one JSON line per shape, then the card's
name and power limit as nvidia-smi reads them.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from ivid_tpu_torch import cuda_build, timing
from ivid_tpu_torch.ops import attention

NAMES = ("packed_attention", "packed_attention_bwd")
PEAK_BF16 = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)


def _fwd(src, qkv, heads, scale, with_lse):
    fn = cuda_build.function(NAMES[0], "packed_attention_fwd_launch", attention._FWD_ARGS, src)
    b, t, c3 = qkv.shape
    out = torch.empty((b, t, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=qkv.device) if with_lse else None
    rc = fn(qkv.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(), b, t, heads,
            scale * scale * math.log2(math.e), 1, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{src}: forward launch failed: CUDA error {rc}")
    return out, lse


def _bwd(src, qkv, out, dout, lse, heads, scale):
    fn = cuda_build.function(NAMES[1], "packed_attention_bwd_launch", attention._BWD_ARGS, src)
    b, t, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    # Scratch large enough for either version's per-row statistics.
    scratch = torch.empty((b, heads, -(-t // 64) * 64, 2), dtype=torch.float32, device=qkv.device)
    s2 = scale * scale
    rc = fn(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dqkv.data_ptr(), b, t, heads, s2 * math.log2(math.e), s2, 1,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{src}: backward launch failed: CUDA error {rc}")
    return dqkv


def _turns(calls, order):
    """(device ms, host ms) of each turn, by version, the turns taken in ``order``."""
    out = {name: [] for name in calls}
    for name in order:
        out[name].append((timing.device_ms(calls[name]), timing.host_ms(calls[name])))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None, help="directory with the other version's sources")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention: no CUDA device")
    srcs = {"this": cuda_build.CSRC}
    if args.other:
        srcs["other"] = Path(args.other).resolve()
    for src in srcs.values():
        cuda_build.build(NAMES, src)
    order = ["other", "this", "this", "other"] if args.other else ["this", "this"]
    dev = torch.device("cuda")
    heads, d, scale = 4, 64, 64 ** -0.25
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, kernel in ((2, "K1"), (8, "K1"), (2, "K4"), (8, "K4")):
        t, c = 1024, heads * d
        qkv = torch.randn((b, t, 3 * c), generator=gen, device=dev).to(torch.bfloat16)
        dout = torch.randn((b, t, c), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = (x.transpose(1, 2).contiguous()
                   for x in qkv.reshape(b, t, heads, 3 * d).split(d, dim=-1))
        with_lse = kernel == "K4" or b == 8  # K1 writes it for training
        if kernel == "K1":
            calls = {n: (lambda s=s: _fwd(s, qkv, heads, scale, with_lse)) for n, s in srcs.items()}
            lib = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
            results = {n: calls[n]()[0] for n in srcs}
            flops = 4 * b * heads * t * t * d
        else:
            out, lse = _fwd(cuda_build.CSRC, qkv, heads, scale, True)
            calls = {n: (lambda s=s: _bwd(s, qkv, out, dout, lse, heads, scale))
                     for n, s in srcs.items()}
            qg, kg, vg = (x.requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
            g4 = dout.reshape(b, t, heads, d).transpose(1, 2).contiguous()
            lib = lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), g4, retain_graph=True)  # noqa: E731
            results = {n: calls[n]() for n in srcs}
            flops = 10 * b * heads * t * t * d
        times = _turns(calls, order)
        line = {
            "kernel": kernel, "shape": [b, t, 3 * c], "with_lse": with_lse,
            "ms": {n: [x[0] for x in v] for n, v in times.items()},
            "host_ms": {n: [x[1] for x in v] for n, v in times.items()},
            "library_ms": timing.device_ms(lib), "library_host_ms": timing.host_ms(lib),
            "bound_ms": flops / PEAK_BF16 * 1e3,
        }
        if "other" in results:
            line["max_abs_diff_vs_other"] = (
                results["this"].float() - results["other"].float()).abs().max().item()
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[torch.cuda.current_device()], flush=True)


if __name__ == "__main__":
    main()
