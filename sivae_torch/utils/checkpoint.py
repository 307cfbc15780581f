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
checkpoints whole. Reading the JAX package's orbax checkpoints needs JAX and
is not done here.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch


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
        return sorted(int(n[:-4]) for n in os.listdir(self.directory)
                      if n.endswith(".pth") and n[:-4].isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> bool:
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        opt_d = None if state.opt_d is None else state.opt_d.state_dict()
        payload = {"model": state.model.state_dict(), "opt_e": state.opt_e.state_dict(),
                   "opt_d": opt_d, "generator": state.generator.get_state(),
                   "generator_device": state.generator.device.type, "step": int(state.step)}
        tmp = self.path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
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
        state.model.load_state_dict(payload["model"])
        state.opt_e.load_state_dict(payload["opt_e"])
        if state.opt_d is not None:
            state.opt_d.load_state_dict(payload["opt_d"])
        state.generator.set_state(payload["generator"])
        state.step = int(payload["step"])
        return state

    def close(self) -> None:
        """Nothing to wait for: every write is finished when `save` returns."""
