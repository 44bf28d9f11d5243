# Frozen copy of jenga_tpu_torch/diffusion/unipc.py (a port of jenga_tpu/diffusion/unipc.py), kept so that the reference imports neither package.
"""UniPC multistep solver for flow matching (Wan's sampler).

Port of ``jenga_tpu/diffusion/unipc.py``, whose module imports
``jax.numpy`` and so cannot be shared: the host code that computes every
solver coefficient in float64 numpy (lambda ratios, the phi series, the
small R\\b solve) is carried over line for line, and the device work per
step is one f32 linear combination of the sample and the cached x0
predictions, in torch. The schedule is an immutable ``UniPCSchedule``
table and the solver state an explicit ``UniPCState`` value; every
function takes the step index from the state.

Flow-matching parametrization: ``alpha_t = 1 - sigma_t``, the model
predicts velocity, ``x0 = x - sigma * v``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["UniPCSchedule", "UniPCState", "unipc_schedule", "unipc_init",
           "unipc_step", "unipc_step_to_zero", "unipc_add_noise"]


@dataclasses.dataclass(frozen=True)
class UniPCSchedule:
    sigmas: np.ndarray          # [N+1], last entry 0 ("zero" final sigma)
    num_train_timesteps: int
    solver_order: int
    lower_order_final: bool
    solver_type: str            # "bh1" | "bh2"

    @property
    def num_steps(self) -> int:
        return len(self.sigmas) - 1

    def timestep(self, i: int) -> float:
        """The model's timestep at step ``i``, truncated to an integer."""
        return float(int(self.sigmas[i] * self.num_train_timesteps))


@dataclasses.dataclass
class UniPCState:
    """Solver state carried between steps (converted x0 outputs cache)."""
    step_index: int
    model_outputs: list          # up to solver_order converted outputs
    last_sample: object | None
    lower_order_nums: int
    this_order: int
    disable_corrector: tuple[int, ...]


def unipc_schedule(num_steps: int, shift: float = 1.0,
                   num_train_timesteps: int = 1000, solver_order: int = 2,
                   lower_order_final: bool = True,
                   solver_type: str = "bh2") -> UniPCSchedule:
    """sigmas: a shifted linspace from 1 - 1/num_train_timesteps down to
    (not including) 0, then a final exact zero."""
    sigma_max = 1.0 - 1.0 / num_train_timesteps
    sigmas = np.linspace(sigma_max, 0.0, num_steps + 1,
                         dtype=np.float64)[:-1]
    sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    sigmas = np.concatenate([sigmas, [0.0]])
    return UniPCSchedule(sigmas=sigmas,
                         num_train_timesteps=num_train_timesteps,
                         solver_order=solver_order,
                         lower_order_final=lower_order_final,
                         solver_type=solver_type)


def unipc_init(schedule: UniPCSchedule,
               disable_corrector: tuple[int, ...] = ()) -> UniPCState:
    del schedule
    return UniPCState(step_index=0, model_outputs=[], last_sample=None,
                      lower_order_nums=0, this_order=1,
                      disable_corrector=tuple(disable_corrector))


def _lam(sigma: float) -> float:
    # lambda = log(alpha) - log(sigma), alpha = 1 - sigma
    with np.errstate(divide="ignore"):
        return float(np.log(1.0 - sigma) - np.log(sigma))


def _phi_coeffs(schedule: UniPCSchedule, hh: float, order: int):
    """b vector and B_h of the B(h) expansion (predict_x0 path: hh = -h)."""
    h_phi_1 = np.expm1(hh)
    B_h = hh if schedule.solver_type == "bh1" else np.expm1(hh)
    b = []
    h_phi_k = h_phi_1 / hh - 1.0
    factorial_i = 1.0
    for i in range(1, order + 1):
        b.append(h_phi_k * factorial_i / B_h)
        factorial_i *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    return np.array(b, np.float64), float(h_phi_1), float(B_h)


def _rks(schedule: UniPCSchedule, i_s0: int, back_indices: list[int],
         h: float):
    lam_s0 = _lam(schedule.sigmas[i_s0])
    rks = [(_lam(schedule.sigmas[si]) - lam_s0) / h for si in back_indices]
    rks.append(1.0)
    return np.array(rks, np.float64)


def _combine(x, scale_x, m0, c_m0, d1s, rhos, c_res, d1_t=None, rho_t=None):
    """Device-side combination in f32; every coefficient is a host float."""
    out = scale_x * x.float() + c_m0 * m0.float()
    for rho, d in zip(rhos, d1s):
        out = out + (c_res * rho) * d.float()
    if d1_t is not None:
        out = out + (c_res * rho_t) * d1_t.float()
    return out


def _predictor(schedule, state, sample, order):
    """UniP B(h) update from sigma[i] to sigma[i+1]."""
    i = state.step_index
    sig_t, sig_s0 = schedule.sigmas[i + 1], schedule.sigmas[i]
    alpha_t = 1.0 - sig_t
    h = _lam(sig_t) - _lam(sig_s0)
    hh = -h

    m0 = state.model_outputs[-1]
    rks = _rks(schedule, i, [i - k for k in range(1, order)], h)
    d1s = [(state.model_outputs[-(k + 1)].float() - m0.float())
           / float(rks[k - 1]) for k in range(1, order)]

    b, h_phi_1, B_h = _phi_coeffs(schedule, hh, order)
    if order == 2:
        rhos = np.array([0.5], np.float64)
    elif order > 2:
        R = np.stack([rks ** (p - 1) for p in range(1, order + 1)])
        rhos = np.linalg.solve(R[:-1, :-1], b[:-1])
    else:
        rhos = np.zeros((0,), np.float64)

    scale_x = sig_t / sig_s0 if sig_s0 != 0 else 0.0
    return _combine(sample, float(scale_x), m0, float(-alpha_t * h_phi_1),
                    d1s, [float(r) for r in rhos], float(-alpha_t * B_h))


def _corrector(schedule, state, converted, order):
    """UniC B(h) correction of the previous predictor step with this
    step's fresh model output."""
    i = state.step_index
    sig_t, sig_s0 = schedule.sigmas[i], schedule.sigmas[i - 1]
    alpha_t = 1.0 - sig_t
    h = _lam(sig_t) - _lam(sig_s0)
    hh = -h

    m0 = state.model_outputs[-1]
    rks = _rks(schedule, i - 1, [i - (k + 1) for k in range(1, order)], h)
    d1s = [(state.model_outputs[-(k + 1)].float() - m0.float())
           / float(rks[k - 1]) for k in range(1, order)]

    b, h_phi_1, B_h = _phi_coeffs(schedule, hh, order)
    if order == 1:
        rhos = np.array([0.5], np.float64)
    else:
        R = np.stack([rks ** (p - 1) for p in range(1, order + 1)])
        rhos = np.linalg.solve(R, b)

    d1_t = converted.float() - m0.float()
    scale_x = sig_t / sig_s0 if sig_s0 != 0 else 0.0
    return _combine(state.last_sample, float(scale_x), m0,
                    float(-alpha_t * h_phi_1), d1s,
                    [float(r) for r in rhos[:-1]], float(-alpha_t * B_h),
                    d1_t=d1_t, rho_t=float(rhos[-1]))


def unipc_step(schedule: UniPCSchedule, state: UniPCState, velocity, sample):
    """One predictor(+corrector) step; returns (new_state, prev_sample).

    A non-empty ``disable_corrector`` suppresses the corrector for the
    flagged previous step, forces order 1 once, and is then cleared as a
    whole (the reference's behaviour, kept on purpose)."""
    i = state.step_index
    sigma = float(schedule.sigmas[i])
    converted = sample.float() - sigma * velocity.float()   # x0 prediction

    if (i > 0 and (i - 1) not in state.disable_corrector
            and state.last_sample is not None):
        sample = _corrector(schedule, state, converted, state.this_order)

    outputs = list(state.model_outputs)[-(schedule.solver_order - 1):] \
        if schedule.solver_order > 1 else []
    outputs.append(converted)

    if schedule.lower_order_final:
        this_order = min(schedule.solver_order, schedule.num_steps - i)
    else:
        this_order = schedule.solver_order
    this_order = min(this_order, state.lower_order_nums + 1)

    disable = state.disable_corrector
    if len(disable) > 0:
        this_order = 1
        disable = ()

    new_state = UniPCState(
        step_index=i + 1,
        model_outputs=outputs,
        last_sample=sample,
        lower_order_nums=min(state.lower_order_nums + 1,
                             schedule.solver_order),
        this_order=this_order,
        disable_corrector=disable,
    )
    # the predictor uses the pre-advance index
    pred_state = dataclasses.replace(new_state, step_index=i)
    return new_state, _predictor(schedule, pred_state, sample, this_order)


def unipc_step_to_zero(schedule: UniPCSchedule, step_index: int, velocity,
                       sample):
    """x0 estimate straight from the current step."""
    sigma = float(schedule.sigmas[step_index])
    return sample.float() - sigma * velocity.float()


def unipc_add_noise(schedule: UniPCSchedule, step_index: int, clean, noise):
    """Re-noise a clean sample to sigma[step_index]."""
    sigma = float(schedule.sigmas[step_index])
    return (1.0 - sigma) * clean.float() + sigma * noise.float()
