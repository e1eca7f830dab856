"""Time the attention kernels K1 and K4 on the card, optionally beside another
version of their sources:

    python -m ivid_tpu_torch.bench_attention [--other DIR] [--dtype bf16|f32|both]

Shapes (64-wide heads, scale 64^-1/4, seeded inputs): the single-category
model's [2, 1024, 768] (sampling) and [8, 1024, 768] (training), 4 heads,
and the flagship 1000-class model's [20, 1024, 1536] (sampling at batch 10
with CFG) and [16, 1024, 1536] (training), 8 heads. K1 runs at all four,
with the log-sum-exp at the training shapes; K4 at [2, 1024, 768] and at
both training shapes. Beside each: the plain version (CUDA events), torch's
scaled_dot_product_attention (forward, or its backward through autograd) on
the same inputs unpacked, with its largest difference from the plain version
and the names of the kernels it ran, and the bound (:func:`bound_ms`).

With ``--other DIR``, ``DIR/packed_attention.cu`` and
``DIR/packed_attention_bwd.cu`` are built too (the same C entry points, for
example an earlier commit's sources unpacked with ``git archive``) and the
two versions run in turns (other, this, this, other) on the same inputs.
Each kernel number is device time from torch.profiler with CUDA events
beside it (``ivid_tpu_torch.timing``). f32 runs with TF32 off for PyTorch's
own products. Prints one JSON line per kernel, type and shape, then the
card's name and power limit as nvidia-smi reads them.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from ivid_tpu_torch import cuda_build, timing
from ivid_tpu_torch.ops import attention

NAMES = ("packed_attention", "packed_attention_bwd")
# The card's published peaks (NVIDIA H100 SXM data sheet, dense).
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_TF32 = 494.7e12

# (batch, T, heads) of each shape the benches and chip_smoke.py time.
SHAPES = {
    "sampling": (2, 1024, 4),
    "training": (8, 1024, 4),
    "flagship sampling": (20, 1024, 8),
    "flagship training": (16, 1024, 8),
}
K4_SHAPES = ("sampling", "training", "flagship training")


def bound_ms(b, t, heads, dtype, backward=False):
    """Least time for packed attention at [b, t, 3·heads·64], in ms, and what
    bounds it: the products' flops (forward 4·B·H·T²·D, backward
    10·B·H·T²·D) or the operand bytes (qkv, out; backward also dout, lse and
    dqkv) at the memory rate, whichever takes longer. bf16 flops run at the
    bf16 tensor-core peak. f32 is bound for the function, not for one
    design: three TF32 tensor-core products per f32-accurate product
    (split-TF32) beat the CUDA cores' 67 TFLOP/s, so 3x the flops at the
    TF32 peak is the least the card can take."""
    d = 64
    size = 2 if dtype == torch.bfloat16 else 4
    flops = (10 if backward else 4) * b * heads * t * t * d
    nbytes = (b * t * 3 * heads * d + b * t * heads * d) * size
    if backward:
        nbytes += (b * t * heads * d + b * t * 3 * heads * d) * size + b * heads * t * 4
    t_ops = flops / PEAK_BF16 if dtype == torch.bfloat16 else 3 * flops / PEAK_TF32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _fwd(src, qkv, heads, scale, with_lse):
    fn = cuda_build.function(NAMES[0], "packed_attention_fwd_launch", attention._FWD_ARGS, src)
    b, t, c3 = qkv.shape
    out = torch.empty((b, t, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=qkv.device) if with_lse else None
    rc = fn(qkv.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(), b, t, heads,
            scale * scale * math.log2(math.e), int(qkv.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
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
            dqkv.data_ptr(), b, t, heads, s2 * math.log2(math.e), s2,
            int(qkv.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{src}: backward launch failed: CUDA error {rc}")
    return dqkv


def _turns(calls, order):
    """(device ms, host ms) of each turn, by version, the turns taken in ``order``."""
    out = {name: [] for name in calls}
    for name in order:
        out[name].append((timing.device_ms(calls[name]), timing.host_ms(calls[name])))
    return out


def kernel_names(fn) -> list:
    """Names of the device activities of one call of ``fn`` (one profiler
    session), largest first: which of its backends a library call took."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [name[:120] for _, _, name in timing.device_rows(prof, 1)]


def unpack(qkv, heads):
    """q, k, v of a packed [B, T, 3C] tensor as contiguous [B, H, T, 64]
    (differentiable: a model's gradient flows through)."""
    b, t, _ = qkv.shape
    d = attention.HEAD_DIM
    return tuple(x.transpose(1, 2).contiguous()
                 for x in qkv.reshape(b, t, heads, 3 * d).split(d, dim=-1))


def sdpa_forward(qkv, heads, scale):
    """torch's SDPA on packed qkv, as the port's [B, T, C] (the yardstick
    beside K1; its default scale 64^-1/2 is K1's scale²)."""
    b, t, c3 = qkv.shape
    q, k, v = unpack(qkv, heads)
    out = F.scaled_dot_product_attention(q, k, v, scale=scale * scale)
    return out.transpose(1, 2).reshape(b, t, c3 // 3)


def sdpa_backward(qkv, dout, heads, scale):
    """SDPA's backward through autograd on a graph built once: a function of
    no arguments for the timing, and the gradient packed as [B, T, 3C]."""
    b, t, c3 = qkv.shape
    q, k, v = (x.requires_grad_() for x in unpack(qkv.detach(), heads))
    out = F.scaled_dot_product_attention(q, k, v, scale=scale * scale)
    g4 = dout.reshape(b, t, heads, attention.HEAD_DIM).transpose(1, 2).contiguous()

    def call():
        return torch.autograd.grad(out, (q, k, v), g4, retain_graph=True)

    dq, dk, dv = call()
    packed = torch.stack([dq, dk, dv], dim=3).transpose(1, 2).reshape(b, t, c3)
    return call, packed


def plain_backward(qkv, dout, heads, scale):
    """Autograd of the plain version, on a graph built once (as
    :func:`sdpa_backward`)."""
    x = qkv.detach().requires_grad_()
    out = attention.reference_attention(x, heads, scale)

    def call():
        return torch.autograd.grad(out, x, dout, retain_graph=True)

    return call, call()[0]


def bench_one(kernel, dtype, shape, srcs, order, gen):
    """One JSON-ready record: K1 or K4 in ``dtype`` at SHAPES[shape]."""
    b, t, heads = SHAPES[shape]
    d, scale = attention.HEAD_DIM, 64 ** -0.25
    dev = torch.device("cuda")
    c = heads * d
    qkv = torch.randn((b, t, 3 * c), generator=gen, device=dev).to(dtype)
    dout = torch.randn((b, t, c), generator=gen, device=dev).to(dtype)
    with_lse = kernel == "K4" or "training" in shape
    if kernel == "K1":
        calls = {n: (lambda s=s: _fwd(s, qkv, heads, scale, with_lse)) for n, s in srcs.items()}
        results = {n: calls[n]()[0] for n in srcs}
        plain = lambda: attention.reference_attention(qkv, heads, scale)  # noqa: E731
        lib = lambda: sdpa_forward(qkv, heads, scale)  # noqa: E731
        want, lib_out = plain(), lib()
    else:
        out, lse = _fwd(cuda_build.CSRC, qkv, heads, scale, True)
        calls = {n: (lambda s=s: _bwd(s, qkv, out, dout, lse, heads, scale)) for n, s in srcs.items()}
        results = {n: calls[n]() for n in srcs}
        plain, want = plain_backward(qkv, dout, heads, scale)
        lib, lib_out = sdpa_backward(qkv, dout, heads, scale)
    times = _turns(calls, order)
    bound, bound_by = bound_ms(b, t, heads, dtype, backward=kernel == "K4")
    line = {
        "kernel": kernel, "dtype": str(dtype).replace("torch.", ""), "shape": [b, t, 3 * c],
        "heads": heads, "input": shape, "with_lse": with_lse,
        "ms": {n: [x[0] for x in v] for n, v in times.items()},
        "host_ms": {n: [x[1] for x in v] for n, v in times.items()},
        "max_abs_err": (results["this"].float() - want.float()).abs().max().item(),
        "plain_ms": timing.host_ms(plain, reps=5, warmup=1),
        "library_ms": timing.device_ms(lib), "library_host_ms": timing.host_ms(lib),
        "library_max_abs_err": (lib_out.float() - want.float()).abs().max().item(),
        "library_kernels": kernel_names(lib)[:3],
        "bound_ms": bound, "bound_by": bound_by,
    }
    if "other" in results:
        line["max_abs_diff_vs_other"] = (
            results["this"].float() - results["other"].float()).abs().max().item()
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None, help="directory with the other version's sources")
    ap.add_argument("--dtype", default="both", choices=("bf16", "f32", "both"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    srcs = {"this": cuda_build.CSRC}
    if args.other:
        srcs["other"] = Path(args.other).resolve()
    for src in srcs.values():
        cuda_build.build(NAMES, src)
    order = ["other", "this", "this", "other"] if args.other else ["this", "this"]
    dtypes = {"bf16": [torch.bfloat16], "f32": [torch.float32],
              "both": [torch.bfloat16, torch.float32]}[args.dtype]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in dtypes:
        for kernel in ("K1", "K4"):
            for shape in SHAPES if kernel == "K1" else K4_SHAPES:
                print(json.dumps(bench_one(kernel, dtype, shape, srcs, order, gen)), flush=True)
                torch.cuda.empty_cache()
    print(timing.card_line(), flush=True)


if __name__ == "__main__":
    main()
