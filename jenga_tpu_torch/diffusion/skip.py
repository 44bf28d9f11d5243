# Copy of jenga_tpu/diffusion/skip.py, kept so that the port never imports it.
"""Timestep-skipping policies: fixed lists and TeaCache, precomputed.

The reference implements skipping as mutable per-call counters on the
transformer class (the reference's `jenga_hyvideo.py:128-179` fixed-list;
the reference's `jenga_wan.py:595-648` TeaCache). Two observations make a
cleaner TPU design possible:

  1. The fixed lists are, by definition, known ahead of time.
  2. The TeaCache metric is the relative L1 change of the *timestep
     modulation embedding* (``e`` or ``e0``), which is a function of the
     timestep alone — not of the latents or the prompt. The whole skip
     schedule is therefore a pure function of the sigma table and can be
     computed before the denoise loop starts, with numerics identical to
     the reference's step-by-step accumulation (cond and uncond branches
     see the same timesteps, so their accumulators evolve identically).

Both policies reduce to a per-step boolean ``compute`` schedule that the
sampler consumes as static python, keeping every jitted step shape-static.
Skipped steps reuse the cached trunk residual (``h_out - h_in``), applied
by the sampler.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "HYVIDEO_NON_SKIP_STEPS", "HYI2V_STEP_CALC",
    "fixed_compute_schedule", "teacache_compute_schedule",
    "TEACACHE_COEFFS",
]

# Fixed skip lists (steps that DO run the transformer), 50-step schedules:
# T2V (the reference's `jenga_hyvideo.py:28`), I2V step_calc
# (the reference's `jenga_hyi2v.py:31-32`).
HYVIDEO_NON_SKIP_STEPS = (0, 1, 2, 3, 4, 7, 10, 13, 16, 19, 22, 25, 26, 29,
                          32, 35, 38, 41, 43, 45, 46, 47, 49)
HYI2V_STEP_CALC = (0, 1, 2, 3, 5, 7, 10, 13, 16, 19, 22, 25, 28, 31, 34,
                   37, 40, 42, 44, 45, 46, 47, 48, 49)

# TeaCache polynomial rescale coefficients per checkpoint
# (the reference's `jenga_wan.py:1085-1098,1200-1213`); key =
# (model, use_ret_steps).
TEACACHE_COEFFS = {
    ("wan-t2v-1.3b", True): (-5.21862437e+04, 9.23041404e+03,
                             -5.28275948e+02, 1.36987616e+01,
                             -4.99875664e-02),
    ("wan-t2v-14b", True): (-3.03318725e+05, 4.90537029e+04,
                            -2.65530556e+03, 5.87365115e+01,
                            -3.15583525e-01),
    ("wan-t2v-1.3b", False): (2.39676752e+03, -1.31110545e+03,
                              2.01331979e+02, -8.29855975e+00,
                              1.37887774e-01),
    ("wan-t2v-14b", False): (-5784.54975374, 5449.50911966, -1811.16591783,
                             256.27178429, -13.02252404),
    ("wan-i2v-480p", True): (2.57151496e+05, -3.54229917e+04,
                             1.40286849e+03, -1.35890334e+01,
                             1.32517977e-01),
    ("wan-i2v-720p", True): (8.10705460e+03, 2.13393892e+03,
                             -3.72934672e+02, 1.66203073e+01,
                             -4.17769401e-02),
    ("wan-i2v-480p", False): (-3.02331670e+02, 2.23948934e+02,
                              -5.25463970e+01, 5.87348440e+00,
                              -2.01973289e-01),
    ("wan-i2v-720p", False): (-114.36346466, 65.26524496, -18.82220707,
                              4.91518089, -0.23412683),
}


def fixed_compute_schedule(num_steps: int, non_skip_steps,
                           stage_starts=()) -> np.ndarray:
    """Boolean [num_steps] schedule: True = run the transformer.

    Stage-switch steps are always computed (the reference forces compute on
    ``start_stage``, the reference's `jenga_hyvideo.py:133-139`).
    """
    compute = np.zeros(num_steps, dtype=bool)
    compute[[s for s in non_skip_steps if s < num_steps]] = True
    for s in stage_starts:
        if 0 <= s < num_steps:
            compute[s] = True
    return compute


def teacache_compute_schedule(metrics, thresh: float, coefficients,
                              ret_steps: int, cutoff_steps: int,
                              stage_starts=()) -> np.ndarray:
    """Replay the reference's TeaCache accumulator over per-step metrics.

    ``metrics[i]`` must be the relative-L1 distance
    ``mean|e_i - e_{i-1}| / mean|e_{i-1}|`` of the modulation embedding
    between consecutive computed calls (metrics[0] unused); ``ret_steps``/
    ``cutoff_steps`` are in *steps* (the reference counts model calls, two
    per CFG step, the reference's `jenga_wan.py:1090-1098` — divide by 2).
    Returns boolean [num_steps] (True = compute).
    """
    poly = np.poly1d(coefficients)
    n = len(metrics)
    compute = np.zeros(n, dtype=bool)
    acc = 0.0
    for i in range(n):
        if i < ret_steps or i >= cutoff_steps or i in stage_starts:
            compute[i] = True
            acc = 0.0
            continue
        acc += float(poly(metrics[i]))
        if acc < thresh:
            compute[i] = False
        else:
            compute[i] = True
            acc = 0.0
    return compute
