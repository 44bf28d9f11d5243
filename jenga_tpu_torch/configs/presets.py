"""Named carving presets over the port's ``HYT2VOptions`` and
``WanT2VOptions``, and the I2V options the JAX CLI builds from them.

Same data as ``jenga_tpu/configs/presets.py`` (which cannot be imported
here: it pulls in the JAX pipelines). Every preset carries ``q_group=8``,
joint 8-row group selection; ``--q-group 1`` or ``--no-joint-sel``
restores the per-row selection. Every preset runs end to end; Turbo,
Flash, 3Stage, AccVideo and the Wan turbo presets switch resolution
between stages (ProRes). The 14B presets run ``WAN_T2V_14B``.
"""

from __future__ import annotations

import dataclasses

from ..pipelines.hyvideo_i2v import HYI2VOptions
from ..pipelines.hyvideo_t2v import HYT2VOptions
from ..pipelines.wan_i2v import WanI2VOptions
from ..pipelines.wan_t2v import WanT2VOptions

__all__ = ["HY_PRESETS", "WAN_PRESETS", "get_hy_preset", "get_wan_preset",
           "get_hy_i2v_options", "get_wan_i2v_options"]


HY_PRESETS: dict[str, HYT2VOptions] = {
    "base": HYT2VOptions(
        q_group=8, sa_drop_rates=(0.75, 0.85), p_remain=0.3,
        res_rate_list=(1.0, 1.0), step_rate_list=(0.5, 1.0),
        scheduler_shift_list=(7.0, 7.0)),
    "turbo": HYT2VOptions(
        q_group=8, sa_drop_rates=(0.7, 0.8), p_remain=0.3,
        res_rate_list=(0.75, 1.0), step_rate_list=(0.5, 1.0),
        scheduler_shift_list=(7.0, 9.0)),
    "flash": HYT2VOptions(
        q_group=8, sa_drop_rates=(0.8, 0.95), p_remain=0.5,
        res_rate_list=(0.75, 1.0), step_rate_list=(0.5, 1.0),
        scheduler_shift_list=(7.0, 9.0)),
    "3stage": HYT2VOptions(
        q_group=8, sa_drop_rates=(0.75, 0.85, 0.85), p_remain=0.3,
        res_rate_list=(0.5, 0.75, 1.0), step_rate_list=(0.3, 0.5, 1.0),
        scheduler_shift_list=(7.0, 9.0, 11.0)),
    "accvideo": HYT2VOptions(
        q_group=8, num_inference_steps=5, sa_drop_rates=(0.7, 0.8),
        p_remain=0.3, res_rate_list=(0.75, 1.0), step_rate_list=(0.5, 1.0),
        scheduler_shift_list=(7.0, 9.0), enable_skip=False),
}


WAN_PRESETS: dict[str, WanT2VOptions] = {
    "1.3b-base": WanT2VOptions(
        q_group=8, sa_drop_rates=(0.75, 0.85), p_remain=0.9, shift=8.0,
        teacache_thresh=0.15, use_ret_steps=True),
    "1.3b-turbo": WanT2VOptions(
        q_group=8, sa_drop_rates=(0.75, 0.85), p_remain=0.9, shift=8.0,
        enable_turbo=True, teacache_thresh=0.15, use_ret_steps=True),
    "14b-base": WanT2VOptions(
        q_group=8, size=(1280, 720), sa_drop_rates=(0.7, 0.8), p_remain=0.8,
        shift=8.0, teacache_thresh=0.15, use_ret_steps=True),
    "14b-turbo": WanT2VOptions(
        q_group=8, size=(1280, 720), sa_drop_rates=(0.5, 0.9), p_remain=0.9,
        shift=8.0, enable_turbo=True, teacache_thresh=0.15,
        use_ret_steps=True),
}


def get_hy_preset(name: str, **overrides) -> HYT2VOptions:
    return dataclasses.replace(HY_PRESETS[name.lower()], **overrides)


def get_wan_preset(name: str, **overrides) -> WanT2VOptions:
    return dataclasses.replace(WAN_PRESETS[name.lower()], **overrides)


def get_hy_i2v_options(name: str, **overrides) -> HYI2VOptions:
    """The JAX CLI's ``hyvideo-i2v`` rule: the T2V preset's value of every
    field ``HYI2VOptions`` shares wins over the I2V default (so the
    preset's ``flow_shift``, ``txt_block_num`` and ``non_skip_steps``
    replace the I2V ones), then the overrides."""
    base = get_hy_preset(name)
    merged = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(base)}
    return HYI2VOptions(**{**merged, **overrides})


def get_wan_i2v_options(max_area: int = 720 * 1280,
                        **overrides) -> WanI2VOptions:
    """The JAX CLI's ``wan-i2v`` rule: no named preset, ``q_group`` 8 as
    the presets carry, and the flow shift 3.0 for areas up to 832x480,
    then the overrides."""
    over = {"max_area": max_area, "q_group": 8}
    if max_area <= 832 * 480:
        over["shift"] = 3.0
    return WanI2VOptions(**{**over, **overrides})
