"""Entry points of the port for a harness: a single-device forward and a
multi-rank dry run, the counterparts of the root ``__graft_entry__.py``.

``entry(device)`` returns ``(fn, args)``: a forward of the flagship model
(the imagenet-128 class-conditional CFG UNet,
``configs/rgbd_imagenet_adm_128_large_cfg.json``, at its fresh
initialization) on a batch of 2, ready to call as ``fn(*args)``. On the
``meta`` device it builds shapes only.

``dryrun_multichip(n, device)`` spawns ``n`` gloo ranks (every rank on
card K with ``cuda:K``, by default card 0, or ``cpu`` where the caller asks
for it) that take ONE training step of a small
class-conditional UNet on a ``(n/2, 2)`` data × model mesh (``(n, 1)`` for
odd ``n``): the batch sharded over the data ranks, the parameters over the
model ranks, the EMA update and the replication check. Rank 0's line
``dryrun_multichip: mesh={'data': D, 'model': 2} loss=... OK`` is printed
by the caller; a rank that fails fails the call.

``python -m ivid_tpu_torch.graft_entry [--device cuda] [--n 8]
[--dryrun_device cuda:0]`` runs the forward once and then the dry run.
"""

from __future__ import annotations

import argparse
import os
import socket
import tempfile
import time

import torch
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "rgbd_imagenet_adm_128_large_cfg.json")

# The small backbone of ``__graft_entry__.py``'s dry run.
DRYRUN_BACKBONE = dict(
    image_size=32, in_channels=4, out_channels=4, model_channels=32,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[16],
    num_groups=8, num_heads=None, num_head_channels=16,
    num_classes=10, has_null_class=True, dropout=0.0, use_fp16=False,
)
DRYRUN_TIMEOUT_S = 300


def entry(device="cuda"):
    """``(fn, (x, t, classes))``: the flagship UNet's forward at batch 2 on
    ``device`` (zero inputs; ``fn`` runs without autograd)."""
    from ivid_tpu_torch.config import Config, build_backbone

    cfg = Config.load(FLAGSHIP)
    device = torch.device(device)
    with device:
        model = build_backbone(cfg).eval()
        s = cfg.backbone["args"]["image_size"]
        x = torch.zeros((2, s, s, cfg.backbone["args"]["in_channels"]))
        t = torch.zeros((2,), dtype=torch.long)
        classes = torch.zeros((2,), dtype=torch.long)

    @torch.no_grad()
    def fn(x, t, classes):
        return model(x, t, classes)

    return fn, (x, t, classes)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _dryrun_rank(rank: int, world: int, port: int, device: str, out_path: str) -> None:
    from ivid_tpu_torch import parallel
    from ivid_tpu_torch.data import SyntheticRGBD
    from ivid_tpu_torch.diffusion.frameworks import build_framework
    from ivid_tpu_torch.models.adm import build_adm_unet
    from ivid_tpu_torch.training.trainer import BasicTrainer

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dev = parallel.init_from_env(device)
    try:
        model_parallel = 2 if world % 2 == 0 and world > 1 else 1
        torch.manual_seed(0)
        model = build_adm_unet(DRYRUN_BACKBONE)
        fw = build_framework("ClassifierFreeGuidance", model,
                             {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.1},
                             device=dev)
        ds = SyntheticRGBD(image_size=32, length=32, num_classes=10, normalize=True,
                           normalize_depth=True, prepocess_depth="z_buffer")
        with tempfile.TemporaryDirectory() as tmp:
            tr = BasicTrainer(fw, ds, tmp, max_steps=1, batch_size=2 * world // model_parallel,
                              i_sample=10 ** 9, i_save=10 ** 9, sample_at_init=False,
                              model_parallel=model_parallel, num_workers=1, device=dev)
            try:
                # The global batch's loss: the mean over the ranks.
                loss = float(parallel.mean_over_ranks(tr.run_step()["loss"]))
            finally:
                tr.close()
            if loss != loss or abs(loss) == float("inf"):
                raise RuntimeError(f"non-finite loss {loss}")
            tr.check_replication()
        if rank == 0:
            mesh = {"data": tr.data_size, "model": tr.groups.model_size}
            with open(out_path, "w") as f:
                f.write(f"dryrun_multichip: mesh={mesh} loss={loss:.4f} OK")
    finally:
        parallel.shutdown()


def dryrun_multichip(n_devices: int, device="cuda:0") -> str:
    """One training step on ``n_devices`` gloo ranks (spawned processes);
    prints rank 0's mesh line and returns it. Raises if a rank fails or the
    ranks do not finish within ``DRYRUN_TIMEOUT_S``."""
    if torch.device(device).type == "cuda" and torch.device(device).index is None:
        raise ValueError("the dry run puts every rank on one device: give 'cpu' or 'cuda:K'")
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.txt")
        ctx = mp.start_processes(_dryrun_rank,
                                 args=(n_devices, _free_port(), str(device), out_path),
                                 nprocs=n_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"the {n_devices} ranks did not finish within "
                                       f"{DRYRUN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        with open(out_path) as f:
            line = f.read()
    print(line, flush=True)
    return line


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda", help="device of entry()'s forward")
    p.add_argument("--n", type=int, default=8, help="ranks of the dry run")
    p.add_argument("--dryrun_device", type=str, default="cuda:0",
                   help="'cuda:K' (every rank on card K) or 'cpu'")
    opt = p.parse_args(argv)
    fn, args = entry(opt.device)
    out = fn(*args)
    print(f"entry() forward OK: {tuple(out.shape)} on {out.device}", flush=True)
    dryrun_multichip(opt.n, opt.dryrun_device)


if __name__ == "__main__":
    main()
