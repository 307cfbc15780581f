"""Checkpoints: the full train state, saved and restored bit for bit.

Port of `sivae_tpu/utils/checkpoint.py:17-51`. The reference saves a bare
`state_dict` every epoch and resumes weights only (utils/my_trainer.py:
476-480, load_model(strict=False) :130-132), losing Adam's moments and the
schedule's position on restart. The JAX package saves the whole train state
with orbax; here each step is one `torch.save` file, `<dir>/<step>.pth`:

    {"model": the model's state_dict (the reference .pth key layout, so
              `utils.jax_import.load_reference_pth` reads this entry),
     "opt_e", "opt_d": both Adams' state_dicts ("opt_d" None for a state
                       with one joint Adam),
     "generator": the state's generator state, "generator_device": its
                  device type ("cuda" or "cpu"), "step": steps taken}

Each write goes to a temporary file in the same directory, then
`os.replace`s it into place, so a run killed mid-write leaves the previous
checkpoints whole. Under data parallelism rank 0 writes (the ranks hold the
same state) and every rank waits at a barrier until the file is in place;
every rank restores, and the caller checks the ranks agree
(`parallel.replicate_state`, as `SoftIntroTrainer.try_resume` does).
Reading the JAX package's orbax checkpoints needs JAX:
`tools/torch_from_orbax.py` converts them into this layout.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import torch

from sivae_torch.parallel.distributed import barrier, is_main_process, main_decides

ORBAX_HINT = ("the JAX package's orbax checkpoints convert into port checkpoints with "
              "`python tools/torch_from_orbax.py <ckpt_dir> <out_dir>` (needs JAX)")


def _steps(directory: str) -> List[int]:
    return sorted(int(n[:-4]) for n in os.listdir(directory)
                  if n.endswith(".pth") and n[:-4].isdigit())


def checkpoint_file(path: str) -> str:
    """A checkpoint argument as one file: a `.pth` file (a reference
    state_dict or a port checkpoint) as it is, a port checkpoint directory as
    its latest step. Anything else (an orbax directory, say) raises
    ValueError naming the converter."""
    if path.endswith(".pth") and not os.path.isdir(path):
        return path
    steps = _steps(path) if os.path.isdir(path) else []
    if not steps:
        raise ValueError(f"{path}: neither a .pth file nor a directory of port checkpoints "
                         f"(<step>.pth); {ORBAX_HINT}")
    return os.path.join(path, f"{steps[-1]}.pth")


def seeded_generator_state(device_type: str, seed: int) -> torch.Tensor:
    """The state of a new generator of `device_type` seeded with `seed`,
    made without that device. A CUDA generator's state is its seed and its
    Philox offset (0 after seeding), 8 bytes each, little-endian."""
    if device_type == "cuda":
        return torch.frombuffer(bytearray(struct.pack("<Qq", seed, 0)), dtype=torch.uint8)
    if device_type == "cpu":
        return torch.Generator().manual_seed(seed).get_state()
    raise ValueError(f"no generator state for device type {device_type!r}")


def state_payload(state) -> dict:
    """The train state as one checkpoint's dict (the layout above)."""
    opt_d = None if state.opt_d is None else state.opt_d.state_dict()
    return {"model": state.model.state_dict(), "opt_e": state.opt_e.state_dict(),
            "opt_d": opt_d, "generator": state.generator.get_state(),
            "generator_device": state.generator.device.type, "step": int(state.step)}


def load_payload(state, payload: dict):
    """Copy a checkpoint's dict into `state`, in place; returns `state`."""
    state.model.load_state_dict(payload["model"])
    state.opt_e.load_state_dict(payload["opt_e"])
    if state.opt_d is not None:
        state.opt_d.load_state_dict(payload["opt_d"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state


class CheckpointManager:
    """save(step, state), restore(state[, step]), latest_step(), all_steps().

    As orbax's manager does, `save` skips (and returns False for) a step that
    is not after the latest one in the directory, and keeps the newest
    `max_to_keep` steps (all when None)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pth")

    def all_steps(self) -> List[int]:
        return _steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> bool:
        """Under data parallelism rank 0 decides and writes; every rank
        returns once the file is in place (a collective: call it on every
        rank)."""
        main = is_main_process()
        latest = self.latest_step() if main else None
        if not main_decides(latest is None or step > latest):
            return False
        if main:
            tmp = self.path(step) + ".tmp"
            torch.save(state_payload(state), tmp)
            os.replace(tmp, self.path(step))
            if self.max_to_keep is not None:
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(self.path(old))
        barrier()
        return True

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint `step` (the latest when None) into `state`, on
        whatever device it lives: tensors are read to the host and copied
        into the model's and optimizers' own tensors. The generator's state
        carries only to a generator of the device type that saved it (a CUDA
        generator's state is a seed and an offset, a CPU one's a Mersenne
        Twister's): another type raises."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self.path(step), map_location="cpu", weights_only=True)
        if payload["generator_device"] != state.generator.device.type:
            raise ValueError(f"{self.path(step)} holds a {payload['generator_device']} "
                             f"generator; the state's is on {state.generator.device.type}")
        if (payload["opt_d"] is None) != (state.opt_d is None):
            raise ValueError(f"{self.path(step)} and the state disagree on a joint optimizer")
        return load_payload(state, payload)

    def close(self) -> None:
        """Nothing to wait for: every write is finished when `save` returns."""
