"""DPM-Solver++ (2M) for flow matching (Wan's ``--sample-solver dpm++``).

Port of ``jenga_tpu/diffusion/dpm.py``, whose module imports
``jax.numpy`` and so cannot be shared. As in ``diffusion/unipc.py``, the
sigma table and every coefficient are host float64 numpy; the device does
one f32 linear combination per step. The schedule is an immutable
``DPMSchedule`` table and the solver state an explicit ``DPMState`` value.

Flow parametrization: alpha = 1 - sigma, lambda = log(alpha) - log(sigma),
x0 = x - sigma * v. The 2M update from sigma_s0 to sigma_t with
h = lambda_t - lambda_s0 and r = h_prev / h:

    x_t = (sigma_t / sigma_s0) x - alpha_t (e^{-h} - 1)
          [(1 + 1/(2r)) D0 - 1/(2r) D1]

At the last step sigma_t = 0: lambda_t is +inf, ``expm1(-inf)`` is -1 and
the update returns the x0 prediction; those infinities stay on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DPMSchedule", "DPMState", "dpm_schedule", "dpm_init",
           "dpm_step", "dpm_step_to_zero", "dpm_add_noise"]


@dataclasses.dataclass(frozen=True)
class DPMSchedule:
    sigmas: np.ndarray          # [N+1], last entry 0
    num_train_timesteps: int
    solver_order: int
    lower_order_final: bool

    @property
    def num_steps(self) -> int:
        return len(self.sigmas) - 1

    @property
    def timesteps(self) -> np.ndarray:
        """The table's timesteps, floored (the reference's int64 cast)."""
        return np.floor(self.sigmas[:-1] * self.num_train_timesteps)

    def timestep(self, i: int) -> float:
        """The model's timestep at step ``i``, truncated to an integer."""
        return float(int(self.sigmas[i] * self.num_train_timesteps))


@dataclasses.dataclass
class DPMState:
    step_index: int
    model_outputs: list         # up to solver_order x0 predictions
    lower_order_nums: int


def dpm_schedule(num_steps: int, shift: float = 1.0,
                 num_train_timesteps: int = 1000, solver_order: int = 2,
                 lower_order_final: bool = True,
                 grid: str = "sampling") -> DPMSchedule:
    """sigmas: a shifted linspace from sigma_max down to (not including)
    0, then a final exact zero. ``grid="sampling"`` (the pipelines'
    default, the reference's dpm++ path) puts sigma_max at 1.0;
    ``"train"`` at 1 - 1/num_train_timesteps."""
    if grid == "sampling":
        sigma_max = 1.0
    elif grid == "train":
        sigma_max = 1.0 - 1.0 / num_train_timesteps
    else:
        raise ValueError(f"grid must be 'sampling' or 'train', got {grid!r}")
    sigmas = np.linspace(sigma_max, 0.0, num_steps + 1,
                         dtype=np.float64)[:num_steps]
    sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    sigmas = np.concatenate([sigmas, [0.0]])
    return DPMSchedule(sigmas=sigmas,
                       num_train_timesteps=num_train_timesteps,
                       solver_order=solver_order,
                       lower_order_final=lower_order_final)


def dpm_init(schedule: DPMSchedule) -> DPMState:
    del schedule
    return DPMState(step_index=0, model_outputs=[], lower_order_nums=0)


def _lam(sigma: float) -> float:
    with np.errstate(divide="ignore"):
        return float(np.log(1.0 - sigma) - np.log(sigma))


def dpm_step(schedule: DPMSchedule, state: DPMState, velocity, sample):
    """One DPM-Solver++ multistep update; returns (new_state, prev_sample)."""
    i = state.step_index
    sigma = float(schedule.sigmas[i])
    d0 = sample.float() - sigma * velocity.float()     # x0 prediction

    outputs = (list(state.model_outputs)[-(schedule.solver_order - 1):]
               if schedule.solver_order > 1 else [])
    outputs.append(d0)

    if schedule.lower_order_final:
        order = min(schedule.solver_order, schedule.num_steps - i)
    else:
        order = schedule.solver_order
    order = min(order, state.lower_order_nums + 1)

    sig_t, sig_s0 = schedule.sigmas[i + 1], schedule.sigmas[i]
    alpha_t = 1.0 - sig_t
    h = _lam(sig_t) - _lam(sig_s0)
    phi = np.expm1(-h)
    scale_x = float(sig_t / sig_s0) if sig_s0 != 0 else 0.0

    if order >= 2 and len(outputs) >= 2:
        h_prev = _lam(sig_s0) - _lam(schedule.sigmas[i - 1])
        r = h_prev / h
        upd = ((1.0 + 1.0 / (2.0 * r)) * outputs[-1]
               + (-1.0 / (2.0 * r)) * outputs[-2])
    else:
        upd = outputs[-1]

    prev = scale_x * sample.float() - float(alpha_t * phi) * upd
    new_state = DPMState(
        step_index=i + 1, model_outputs=outputs,
        lower_order_nums=min(state.lower_order_nums + 1,
                             schedule.solver_order))
    return new_state, prev


def dpm_step_to_zero(schedule: DPMSchedule, step_index: int, velocity,
                     sample):
    """x0 estimate straight from the current step."""
    sigma = float(schedule.sigmas[step_index])
    return sample.float() - sigma * velocity.float()


def dpm_add_noise(schedule: DPMSchedule, step_index: int, clean, noise):
    """Re-noise a clean sample to sigma[step_index]."""
    sigma = float(schedule.sigmas[step_index])
    return (1.0 - sigma) * clean.float() + sigma * noise.float()
