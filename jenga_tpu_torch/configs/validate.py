# Copy of jenga_tpu/configs/validate.py, kept so that the port never imports it.
"""Input validation: fail fast with clear errors instead of shape errors
deep inside jit.

Counterpart of the reference's scattered checks (``check_inputs``
the reference's `hyvideo/diffusion/pipelines/pipeline_hunyuan_video.py:
482-531`, ``sanity_check_args`` the reference's `hyvideo/config.py:471-485`,
``_validate_args`` the reference's `jenga_wan.py:666-694`), consolidated
into one typed layer over the option dataclasses.
"""

from __future__ import annotations

__all__ = ["validate_hy_options", "validate_wan_options", "ValidationError"]


class ValidationError(ValueError):
    """Raised when generation options are inconsistent."""


def _fail(msg: str):
    raise ValidationError(msg)


def validate_hy_options(opts) -> None:
    """Validate HYT2VOptions / HYI2VOptions before any tracing happens."""
    w, h = opts.size
    if h % 16 or w % 16:
        _fail(f"size (W, H)=({w}, {h}) must be divisible by 16 "
              f"(2x2 patchify on 8x spatially-compressed latents)")
    vl = opts.video_length
    if vl != 1 and (vl - 1) % 4 != 0:
        _fail(f"video_length={vl} must be 1 or 4k+1 "
              f"(the 884 VAE compresses time 4x causally)")
    if opts.num_inference_steps <= 0:
        _fail(f"num_inference_steps={opts.num_inference_steps} must be > 0")

    n_stage = len(opts.res_rate_list)
    if len(opts.step_rate_list) != n_stage:
        _fail(f"step_rate_list has {len(opts.step_rate_list)} entries but "
              f"res_rate_list has {n_stage}; one per ProRes stage")
    if len(opts.scheduler_shift_list) != n_stage:
        _fail(f"scheduler_shift_list has {len(opts.scheduler_shift_list)} "
              f"entries but res_rate_list has {n_stage}")
    if not opts.sa_drop_rates:
        _fail("sa_drop_rates must not be empty")
    for r in opts.sa_drop_rates:
        if not 0.0 <= r < 1.0:
            _fail(f"sa_drop_rate {r} must be in [0, 1)")
    for r in opts.res_rate_list:
        if not 0.0 < r <= 1.0:
            _fail(f"res_rate {r} must be in (0, 1]")
    if opts.res_rate_list[-1] != 1.0:
        _fail("the last ProRes stage must run at full resolution "
              "(res_rate_list[-1] == 1.0)")
    if sorted(opts.step_rate_list) != list(opts.step_rate_list) \
            or opts.step_rate_list[-1] != 1.0:
        _fail(f"step_rate_list {opts.step_rate_list} must be ascending and "
              f"end at 1.0")
    if not 0.0 < opts.p_remain <= 1.0:
        _fail(f"p_remain={opts.p_remain} must be in (0, 1]")
    if opts.txt_block_num < 1:
        _fail(f"txt_block_num={opts.txt_block_num} must be >= 1")
    # every stage's latent grid must be patchifiable
    lt = 1 + (vl - 1) // 4
    for rate in opts.res_rate_list:
        ph, pw = int(h * rate), int(w * rate)
        if ph // 16 == 0 or pw // 16 == 0:
            _fail(f"res_rate {rate} collapses size ({w}, {h}) below one "
                  f"16px patch")
    cond = getattr(opts, "i2v_condition_type", None)
    if cond is not None and cond not in ("token_replace", "latent_concat"):
        _fail(f"i2v_condition_type={cond!r} must be token_replace or "
              f"latent_concat")


def validate_wan_options(opts) -> None:
    """Validate WanT2VOptions / WanI2VOptions."""
    w, h = opts.size
    if h % 16 or w % 16:
        _fail(f"size (W, H)=({w}, {h}) must be divisible by 16 "
              f"(2x2 patchify on 8x spatially-compressed latents)")
    fn = opts.frame_num
    if fn != 1 and (fn - 1) % 4 != 0:
        _fail(f"frame_num={fn} must be 1 or 4k+1 (4x temporal VAE stride)")
    if opts.sampling_steps <= 0:
        _fail(f"sampling_steps={opts.sampling_steps} must be > 0")
    if not opts.sa_drop_rates:
        _fail("sa_drop_rates must not be empty")
    for r in opts.sa_drop_rates:
        if not 0.0 <= r < 1.0:
            _fail(f"sa_drop_rate {r} must be in [0, 1)")
    if not 0.0 < opts.p_remain <= 1.0:
        _fail(f"p_remain={opts.p_remain} must be in (0, 1]")
    if opts.guide_scale < 0:
        _fail(f"guide_scale={opts.guide_scale} must be >= 0")
    if opts.enable_turbo and not (
            0 < opts.turbo_switch_step < opts.sampling_steps):
        _fail(f"turbo_switch_step={opts.turbo_switch_step} must lie inside "
              f"(0, sampling_steps={opts.sampling_steps})")
    if opts.teacache_thresh is not None and opts.teacache_thresh < 0:
        _fail(f"teacache_thresh={opts.teacache_thresh} must be >= 0 or None")
