"""Checkpoint files: the JAX package's three-files-per-step layout under
``{output_dir}/ckpts`` (``model_step{N:07d}``, ``ema_{rate}_step{N:07d}``,
``misc_step{N:07d}``). The port writes ``torch.save`` files of state dicts
(``.pt``); it reads those and the JAX package's flax msgpack files
(``.msgpack``, through :mod:`flax_msgpack`, their names converted by
``models/convert.py``). Every write is atomic (a temporary file, then a
rename), and the trainers write the model file last, so
:func:`find_latest_step` only finds complete steps.

:func:`load_model_state` reads a model or EMA file of either kind, or a
reference PyTorch state dict; :func:`finetune_load` reads one for
finetuning a model with more input channels (the channel-pad finetune of
the JAX package's ``checkpoint.finetune_load``). :func:`read_jax_misc` reads
the JAX trainer's misc file, whose optimizer state is optax's ``adamw``
chain; :func:`jax_misc` builds one.
"""

from __future__ import annotations

import os
import re
from collections import Counter
from typing import Any, Dict, Optional

import numpy as np
import torch

from ivid_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from ivid_tpu_torch.training import flax_msgpack

STEP_RE = re.compile(r"model_step(\d+)\.(pt|msgpack)$")
PT, MSGPACK = ".pt", ".msgpack"


def model_path(output_dir: str, step: int, suffix: str = PT) -> str:
    return os.path.join(output_dir, "ckpts", f"model_step{step:07d}{suffix}")


def ema_path(output_dir: str, rate: float, step: int, suffix: str = PT) -> str:
    return os.path.join(output_dir, "ckpts", f"ema_{rate}_step{step:07d}{suffix}")


def misc_path(output_dir: str, step: int, suffix: str = PT) -> str:
    return os.path.join(output_dir, "ckpts", f"misc_step{step:07d}{suffix}")


def find_latest_step(output_dir: str) -> Optional[int]:
    """The latest step with a model file, ``.pt`` or ``.msgpack``, or None.
    Raises ``ValueError`` if a step has a model file of each kind."""
    ckpt_dir = os.path.join(output_dir, "ckpts")
    if not os.path.isdir(ckpt_dir):
        return None
    steps = Counter(int(m.group(1)) for name in os.listdir(ckpt_dir)
                    if (m := STEP_RE.search(name)))
    both = sorted(s for s, n in steps.items() if n > 1)
    if both:
        raise ValueError(f"{ckpt_dir}: steps {both} have both a .pt and a .msgpack model file")
    return max(steps) if steps else None


def step_suffix(output_dir: str, step: int) -> str:
    """``.pt`` or ``.msgpack``: the kind of the checkpoint of ``step``.
    Raises ``ValueError`` if both kinds are there, ``FileNotFoundError`` if
    neither is."""
    found = [s for s in (PT, MSGPACK) if os.path.exists(model_path(output_dir, step, s))]
    if len(found) > 1:
        raise ValueError(f"{output_dir}: step {step} has both a .pt and a .msgpack model file")
    if not found:
        raise FileNotFoundError(model_path(output_dir, step))
    return found[0]


def save(path: str, obj: Any) -> None:
    """``torch.save`` through a temporary file and a rename."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load(path: str) -> Any:
    """A file written by :func:`save`, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_state(path: str, arch_args: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The port's state dict (CPU tensors) in a model or EMA file: a JAX
    package ``.msgpack`` file, converted for the architecture ``arch_args``
    (``AdmUnet2d.arch_args``), or a ``.pt`` state dict (the port's, or a
    reference checkpoint, whose ``freqs`` buffers are dropped)."""
    if path.endswith(MSGPACK):
        if arch_args is None:
            raise ValueError(f"{path}: a flax checkpoint needs the model's arch_args")
        return flax_to_state_dict(flax_msgpack.read(path), **arch_args)
    return {k: v for k, v in load(path).items() if not k.endswith("freqs")}


IN_CONV = "input_blocks.0.0.weight"


def pad_input_channels(state: Dict[str, torch.Tensor], in_channels: int) -> Dict[str, torch.Tensor]:
    """``state`` with the first convolution's weight [O, I, kh, kw]
    zero-padded along I to ``in_channels``: the added inputs start with no
    effect on the output."""
    w = state[IN_CONV]
    if w.shape[1] > in_channels:
        raise ValueError(f"{IN_CONV} has {w.shape[1]} input channels, more than {in_channels}")
    if w.shape[1] == in_channels:
        return state
    pad = w.new_zeros((w.shape[0], in_channels - w.shape[1]) + tuple(w.shape[2:]))
    return dict(state, **{IN_CONV: torch.cat([w, pad], dim=1)})


def finetune_load(path: str, model_state: Dict[str, torch.Tensor],
                  arch_args: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The state dict in ``path`` (see :func:`load_model_state`; a
    ``.msgpack`` file needs ``arch_args``, the model's: the names do not
    depend on the input channels) made to fit ``model_state``: the first
    convolution zero-padded to the model's input channels. Raises
    ``ValueError`` unless every name and shape then matches
    ``model_state``."""
    state = load_model_state(path, arch_args)
    state = pad_input_channels(state, model_state[IN_CONV].shape[1])
    missing = sorted(set(model_state) - set(state))
    unexpected = sorted(set(state) - set(model_state))
    if missing or unexpected:
        raise ValueError(f"{path}: missing {missing}, unexpected {unexpected}")
    wrong = {k: (tuple(v.shape), tuple(model_state[k].shape))
             for k, v in state.items() if v.shape != model_state[k].shape}
    if wrong:
        raise ValueError(f"{path}: shape mismatch (checkpoint, model): {wrong}")
    return state


def read_jax_misc(path: str, arch_args: dict) -> dict:
    """The JAX trainer's ``misc_step*.msgpack``: ``step``, ``rng`` (the
    uint32[2] PRNG key), ``loader_pos``, ``ema_rates``, and AdamW's state as
    ``exp_avg``, ``exp_avg_sq`` (the port's state dicts of optax's
    ``ScaleByAdamState`` ``mu`` and ``nu``) and ``adam_step`` (its
    ``count``). The optimizer state must be ``optax.adamw``'s chain with a
    constant learning rate, ``{"0": {count, mu, nu}, "1": {}, "2": {}}``, as
    the JAX trainer writes it."""
    misc = flax_msgpack.read(path)
    missing = sorted({"opt_state", "step", "rng", "loader_pos", "ema_rates"} - set(misc))
    if missing:
        raise ValueError(f"{path}: not a JAX trainer's misc file (no {missing})")
    opt = misc["opt_state"]
    if not (isinstance(opt, dict) and sorted(opt) == ["0", "1", "2"]
            and isinstance(opt["0"], dict) and sorted(opt["0"]) == ["count", "mu", "nu"]
            and opt["1"] == {} and opt["2"] == {}):
        raise ValueError(f"{path}: opt_state is not optax.adamw's chain "
                         "({'0': {count, mu, nu}, '1': {}, '2': {}})")
    adam = opt["0"]
    return {
        "step": int(misc["step"]),
        "rng": [int(w) for w in np.asarray(misc["rng"]).reshape(-1)],
        "loader_pos": [int(x) for x in np.asarray(misc["loader_pos"])],
        "ema_rates": [float(r) for r in np.asarray(misc["ema_rates"])],
        "adam_step": int(adam["count"]),
        "exp_avg": flax_to_state_dict(adam["mu"], **arch_args),
        "exp_avg_sq": flax_to_state_dict(adam["nu"], **arch_args),
    }


def jax_misc(*, step: int, adam_step: int, exp_avg: dict, exp_avg_sq: dict, rng,
             loader_pos, ema_rates, arch_args: dict) -> dict:
    """The tree of a JAX trainer's misc file for these values (the inverse
    of :func:`read_jax_misc`), for :func:`flax_msgpack.write`."""
    return {
        "opt_state": ({"count": np.asarray(adam_step, np.int32),
                       "mu": state_dict_to_flax(exp_avg, **arch_args),
                       "nu": state_dict_to_flax(exp_avg_sq, **arch_args)}, {}, {}),
        "step": int(step),
        "rng": np.asarray(rng, np.uint32),
        "loader_pos": np.asarray(loader_pos, np.int64),
        "ema_rates": np.asarray(ema_rates, np.float64),
    }
