"""The HunyuanVideo family at a tiny CPU size, and the faults the check
tests plant in its timed path; ``wrap_output`` edits the velocity where
the model produces it, its head."""

from _tiny import wrap_model_head as wrap_output  # noqa: F401


def tiny(workload: dict, config: dict, dtype: str):
    """A cell's own (workload, config) with the widths, depth, frames and
    steps cut down."""
    config.update(hidden_size=256, heads_num=2, double_blocks=1,
                  single_blocks=2, text_states_dim=64, text_states_dim_2=32,
                  dtype=dtype)
    workload["sampler"].update(size=[256, 128], video_length=33,
                               num_inference_steps=6)
    workload["text_tokens"] = [256, 40]
    return workload, config


def state_unchanged(monkeypatch):
    """The flow-matching Euler step returns the sample it was given."""
    from jenga_tpu_torch.diffusion.flow_match import FlowMatchSchedule
    monkeypatch.setattr(FlowMatchSchedule, "step",
                        lambda self, i, sample, velocity: sample.float())

