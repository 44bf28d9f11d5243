"""Named carving presets over the port's ``HYT2VOptions`` and
``WanT2VOptions``.

Same data as ``jenga_tpu/configs/presets.py`` (which cannot be imported
here: it pulls in the JAX pipelines). Every preset carries ``q_group=8``,
joint 8-row group selection; ``--q-group 1`` or ``--no-joint-sel``
restores the per-row selection. Every HunyuanVideo preset and the Wan
1.3B ones run end to end; Turbo, Flash, 3Stage, AccVideo and 1.3b-turbo
switch resolution between stages (ProRes). The 14B presets are data
only: the CLI refuses Wan 14B runs.
"""

from __future__ import annotations

import dataclasses

from ..pipelines.hyvideo_t2v import HYT2VOptions
from ..pipelines.wan_t2v import WanT2VOptions

__all__ = ["HY_PRESETS", "WAN_PRESETS", "get_hy_preset", "get_wan_preset"]


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
