"""What every cell shares, whatever its model family: the benchmark's
seeded weights by group, the seeds of each clip, the uniform draw of the
window step that the reference checks, and freeing the program before
the reference runs."""

from __future__ import annotations

import gc

import numpy as np
import torch

from ..traffic import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class CellBase:
    """``reference`` is the family's reference module (``param_groups``);
    ``tie`` the family's aligned-attention init of a weight group;
    ``controls`` the precision controls (``run.py --control``) the family
    takes."""

    reference = None
    controls = ("fp8ref",)

    def __init__(self, config: dict, workload: dict, seed: int, device,
                 control: str | None):
        if control not in (None, *self.controls):
            raise ValueError(f"control {control!r}: this family takes "
                             f"{self.controls}")
        self.config, self.workload, self.seed = config, workload, seed
        self.control = control
        self.device = torch.device(device)
        self.dtype = DTYPES[config["dtype"]]
        self.aligned = workload.get("aligned_init", True)
        self.warmup_steps = int(workload["warmup_steps"])
        self.recording = False      # set by the harness when the window opens
        self.pick = None            # the window step the reference checks
        self.inputs = {}            # each clip's inputs
        self._rng = np.random.default_rng(seed)
        self._seen = 0

    def tie(self, group: dict) -> dict:
        raise NotImplementedError

    def group(self, index: int, specs) -> dict:
        g = weights.make_group(specs, self.seed, index, self.dtype,
                               self.device)
        return self.tie(g) if self.aligned else g

    def all_weights(self) -> dict:
        """The whole state dict, handed to the program once."""
        params = {}
        for index, (_, specs) in enumerate(
                self.reference.param_groups(self.config)):
            params.update(self.group(index, specs))
        return params

    def weights_by_name(self):
        """``group(name)``: one group drawn again, for the reference."""
        groups = self.reference.param_groups(self.config)
        index = {name: i for i, (name, _) in enumerate(groups)}
        return lambda name: self.group(index[name], groups[index[name]][1])

    def clip_generator(self, clip: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            weights.group_seed(self.seed, 100000 + clip))

    def clip_seed(self, clip: int) -> int:
        """The sampler's own seed for a clip (its draws are replaced by the
        benchmark's inputs)."""
        return int(weights.group_seed(self.seed, 200000 + clip) % 2 ** 31)

    def offer(self, record: dict):
        """A window step finished: keep it as the checked one with
        probability 1/n at the n-th, a uniform draw from the seed over
        the window's steps."""
        if self.recording:
            self._seen += 1
            if self._rng.random() * self._seen < 1.0:
                self.pick = record

    def release(self):
        """Free the program's model before the reference runs."""
        self.sampler = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
