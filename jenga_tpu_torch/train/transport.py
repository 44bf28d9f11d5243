"""Flow-matching transport for training: interpolant paths, t sampling and
the per-example loss.

Port of ``jenga_tpu/train/transport.py`` (the reference's
Transport/ICPlan stack as pure functions of ``(t, x0, x1)`` and a frozen
``TransportConfig``): the LINEAR / GVP / VP paths, velocity / noise /
score parameterizations, none / velocity / likelihood loss weights,
uniform / lognorm t sampling with the SD3 time shift, and the I2V
latent_concat and token_replace conditioning.

Random draws come from an explicit ``torch.Generator``. JAX splits one key
into the t draw and the noise; the two generators give other numbers from
the same seed, so parity goes through the draws themselves: ``timestep``
(as JAX's) fixes t, and ``noise`` fixes x0.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["TransportConfig", "path_coefficients", "sample_t",
           "interpolate", "training_loss"]


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Same fields and defaults as the JAX config."""
    path_type: str = "linear"        # linear | gvp | vp
    prediction: str = "velocity"     # velocity | noise | score
    loss_weight: str = "none"        # none | velocity | likelihood
    snr_type: str = "uniform"        # uniform | lognorm
    shift: float = 1.0               # SD3 time shift (video_shift)
    reverse: bool = False            # reverse=True: x_t = (1-t) x1 + t x0
    reverse_time_schedule: bool = False
    training_timesteps: float = 1000.0
    train_eps: float = 0.0
    vp_sigma_min: float = 0.1
    vp_sigma_max: float = 20.0


def path_coefficients(cfg: TransportConfig, t):
    """(alpha_t, d_alpha_t, sigma_t, d_sigma_t): x_t = alpha_t x1 +
    sigma_t x0 (data coefficient alpha, noise coefficient sigma)."""
    if cfg.path_type == "linear":
        if cfg.reverse:
            return 1.0 - t, -torch.ones_like(t), t, torch.ones_like(t)
        return t, torch.ones_like(t), 1.0 - t, -torch.ones_like(t)
    if cfg.path_type == "gvp":
        half_pi = math.pi / 2.0
        alpha = torch.sin(t * half_pi)
        d_alpha = half_pi * torch.cos(t * half_pi)
        sigma = torch.cos(t * half_pi)
        d_sigma = -half_pi * torch.sin(t * half_pi)
        return alpha, d_alpha, sigma, d_sigma
    if cfg.path_type == "vp":
        smin, smax = cfg.vp_sigma_min, cfg.vp_sigma_max
        log_mean = -0.25 * (1 - t) ** 2 * (smax - smin) - 0.5 * (1 - t) * smin
        d_log_mean = 0.5 * (1 - t) * (smax - smin) + 0.5 * smin
        alpha = torch.exp(log_mean)
        d_alpha = alpha * d_log_mean
        sigma = torch.sqrt(1.0 - torch.exp(2.0 * log_mean))
        d_sigma = torch.exp(2.0 * log_mean) * (2.0 * d_log_mean) \
            / (-2.0 * sigma)
        return alpha, d_alpha, sigma, d_sigma
    raise ValueError(f"unknown path_type {cfg.path_type!r}")


def sample_t(cfg: TransportConfig, generator: torch.Generator | None,
             batch: int, device="cpu"):
    """Per-example interpolation times [batch] f32: a uniform or a
    logit-normal draw from ``generator``, then the SD3 shift."""
    t0, t1 = cfg.train_eps, 1.0 - cfg.train_eps
    if cfg.path_type == "linear" and cfg.prediction == "velocity":
        t0, t1 = 0.0, 1.0
    if cfg.snr_type == "uniform":
        t = torch.rand((batch,), generator=generator, device=device) \
            * (t1 - t0) + t0
    elif cfg.snr_type == "lognorm":
        u = torch.randn((batch,), generator=generator, device=device)
        t = torch.sigmoid(u) * (t1 - t0) + t0
    else:
        raise ValueError(f"unknown snr_type {cfg.snr_type!r}")
    s = cfg.shift
    if s != 1.0:
        if cfg.reverse:
            t = (s * t) / (1.0 + (s - 1.0) * t)
        else:
            t = t / (s - (s - 1.0) * t)
    return t


def interpolate(cfg: TransportConfig, t, x0, x1):
    """(x_t, u_t): the noisy sample and its target vector field."""
    te = t.reshape(t.shape + (1,) * (x1.ndim - 1))
    alpha, d_alpha, sigma, d_sigma = path_coefficients(cfg, te)
    xt = alpha * x1 + sigma * x0
    ut = d_alpha * x1 + d_sigma * x0
    return xt, ut


def _model_t(cfg: TransportConfig, t):
    if cfg.reverse_time_schedule:
        return (1.0 - t) * cfg.training_timesteps
    return t * cfg.training_timesteps


def training_loss(cfg: TransportConfig, model_fn, generator, x1, *,
                  i2v_condition_type: str | None = None,
                  cond_latents=None, timestep=None, noise=None):
    """Per-example flow-matching loss. ``model_fn(xt, t_model)`` runs the
    DiT; ``cond_latents`` [B, C, 1, h, w] drives the I2V conditioning
    modes. ``timestep`` (a scalar or [B]) replaces the t draw and
    ``noise`` (x1's shape) the noise draw. Returns (loss [B], aux dict)."""
    b = x1.shape[0]
    dev = x1.device
    t = sample_t(cfg, generator, b, dev) if timestep is None else \
        torch.as_tensor(timestep, dtype=torch.float32,
                        device=dev).expand(b)
    x0 = torch.randn(x1.shape, generator=generator, device=dev) \
        if noise is None else torch.as_tensor(noise, dtype=torch.float32,
                                              device=dev)
    xt, ut = interpolate(cfg, t, x1.float(), x0)

    if i2v_condition_type == "latent_concat":
        # clean first-frame latents + binary mask as extra channels
        rep = (cond_latents if cond_latents is not None
               else x1[:, :, :1]).float().expand(x1.shape)
        rep = torch.cat([rep[:, :, :1], torch.zeros_like(rep[:, :, 1:])],
                        dim=2)
        msk = torch.zeros((b, 1) + tuple(x1.shape[2:]), device=dev)
        msk[:, :, 0] = 1.0
        xt_in = torch.cat([xt, rep, msk], dim=1)
    elif i2v_condition_type == "token_replace":
        xt_in = torch.cat([cond_latents.float(), xt[:, :, 1:]], dim=2)
    else:
        xt_in = xt

    out = model_fn(xt_in, _model_t(cfg, t))

    if i2v_condition_type == "token_replace":
        out = out[:, :, 1:]
        ut = ut[:, :, 1:]

    out = out.float()
    axes = tuple(range(1, out.ndim))
    if cfg.prediction == "velocity":
        loss = torch.mean((out - ut) ** 2, dim=axes)
    else:
        te = t.reshape(t.shape + (1,) * (out.ndim - 1))
        _, _, sigma, d_sigma = path_coefficients(cfg, te)
        # drift diffusion term (the reference's ICPlan.compute_drift)
        if cfg.path_type == "linear" and not cfg.reverse:
            ratio = 1.0 / te
        elif cfg.path_type == "gvp":
            ratio = math.pi / (2.0 * torch.tan(te * math.pi / 2.0))
        else:
            ratio = 1.0 / te
        diffusion = ratio * sigma ** 2 - sigma * d_sigma
        if cfg.loss_weight == "velocity":
            weight = (diffusion / sigma) ** 2
        elif cfg.loss_weight == "likelihood":
            weight = diffusion / sigma ** 2
        else:
            weight = torch.ones_like(sigma)
        x0c = x0[:, :, 1:] if i2v_condition_type == "token_replace" else x0
        if cfg.prediction == "noise":
            loss = torch.mean(weight * (out - x0c) ** 2, dim=axes)
        else:  # score
            loss = torch.mean(weight * (out * sigma + x0c) ** 2, dim=axes)
    return loss, {"t": t, "xt": xt, "ut": ut}
