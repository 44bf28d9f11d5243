"""The Wan family at a tiny CPU size, and the faults the check tests
plant in its timed path; ``wrap_output`` edits the velocity where the
model produces it, its head, on the CFG batch of 2."""

from _tiny import wrap_model_head as wrap_output  # noqa: F401


def tiny(workload: dict, config: dict, dtype: str):
    """A cell's own (workload, config) with the widths, depth, frames and
    steps cut down."""
    config.update(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                  text_dim=64, text_len=32, dtype=dtype)
    workload["sampler"].update(size=[384, 384], frame_num=17,
                               sampling_steps=12)
    workload["warmup_steps"] = min(workload["warmup_steps"], 2)
    workload["text_tokens"] = [8, 20]
    return workload, config


def state_unchanged(monkeypatch):
    """UniPC's step returns the sample it was given."""
    from jenga_tpu_torch.diffusion import unipc
    orig = unipc.unipc_step

    def step(schedule, state, velocity, sample):
        new_state, _ = orig(schedule, state, velocity, sample)
        return new_state, sample
    monkeypatch.setattr(unipc, "unipc_step", step)

