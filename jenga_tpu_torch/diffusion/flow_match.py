"""Euler flow-matching schedule.

Port of ``jenga_tpu/diffusion/flow_match.py``: an immutable table of
sigmas on the host (numpy), and every operation takes the step index
explicitly. Updates run in f32 on the sample's device.

  * SD3 time shift:       sigma' = s*sigma / (1 + (s-1)*sigma)
  * Euler step:           x_{i+1} = x_i + v * (sigma_{i+1} - sigma_i)
  * x0 estimate (ProRes): x0_hat  = x_i + v * (sigma_last - sigma_i)
  * re-noise (ProRes):    x_i     = (1-sigma_i)*x0 + sigma_i*noise
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FlowMatchSchedule", "flow_match_schedule"]


def _sd3_time_shift(t: np.ndarray, shift: float) -> np.ndarray:
    return (shift * t) / (1.0 + (shift - 1.0) * t)


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """``sigmas`` has ``num_steps + 1`` entries, descending 1 -> 0;
    ``timestep(i) = sigmas[i] * num_train_timesteps``."""

    sigmas: np.ndarray
    num_train_timesteps: int
    shift: float

    def timestep(self, i: int) -> float:
        return float(self.sigmas[i] * self.num_train_timesteps)

    def step(self, i: int, sample, velocity):
        dt = float(self.sigmas[i + 1] - self.sigmas[i])
        return sample.float() + velocity.float() * dt

    def predict_x0(self, i: int, sample, velocity):
        """Clean-state estimate: integrate straight to the last sigma."""
        d = float(self.sigmas[-1] - self.sigmas[i])
        return sample.float() + velocity.float() * d

    def renoise_to_step(self, i: int, clean, noise):
        """Blend fresh noise back in to land exactly at sigma_i."""
        s = float(self.sigmas[i])
        return clean.float() * (1.0 - s) + noise.float() * s


def flow_match_schedule(num_steps: int, shift: float = 1.0,
                        num_train_timesteps: int = 1000) -> FlowMatchSchedule:
    sigmas = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    sigmas = _sd3_time_shift(sigmas, shift)
    return FlowMatchSchedule(sigmas=sigmas.astype(np.float32),
                             num_train_timesteps=num_train_timesteps,
                             shift=shift)
