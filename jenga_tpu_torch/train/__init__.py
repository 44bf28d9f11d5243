"""LoRA fine-tuning: flow-matching transport, adapters, dataset, the step.

Port of ``jenga_tpu/train``. JAX's step is a jitted pure function that
returns the new adapters and optimizer state; here the adapters are leaf
tensors that a ``torch.optim`` optimizer updates in place, and the step
returns the loss. The base weights are frozen (``requires_grad_(False)``);
only the adapters get gradients, through the merged weights
(``lora.apply_lora``). Carved forwards train too: the block-sparse
kernel's backward recomputes through the dense oracle one (batch, head)
slice at a time (``ops/sparse_dispatch``), and the dense kernel D has its
own backward kernels (``ops/flash_attention``); pair video-length
sequences with ``remat=True`` on the trunk.
"""

from __future__ import annotations

from .lora import apply_lora, init_lora
from .transport import TransportConfig, training_loss

__all__ = ["TransportConfig", "training_loss", "init_lora", "apply_lora",
           "make_lora_train_step"]


def make_lora_train_step(model_apply, tcfg: TransportConfig, optimizer,
                         i2v_condition_type: str | None = None):
    """Build a LoRA fine-tuning step.

    ``model_apply(params, xt, t, batch)`` runs the DiT with ``params``, the
    merged ``{name: tensor}`` (for example ``torch.func.functional_call(
    model, params, (xt, t, batch["context"]))``); ``optimizer`` is any
    ``torch.optim`` optimizer over the adapter tensors
    (``lora.lora_tensors``). ``torch.optim.AdamW(..., weight_decay=1e-4)``
    is the update of ``optax.adamw``'s defaults.

    Returns ``step(lora, base, batch, generator=None, *, timestep=None,
    noise=None) -> loss``: one optimizer step on the mean flow-matching
    loss of ``batch["latents"]`` (and ``batch["cond_latents"]`` for I2V),
    with t and the noise drawn from ``generator`` unless given.
    """

    def step(lora, base, batch, generator=None, *, timestep=None,
             noise=None):
        for w in base.values():
            w.requires_grad_(False)
        params = apply_lora(base, lora)

        def model_fn(xt, t):
            return model_apply(params, xt, t, batch)

        loss, _ = training_loss(
            tcfg, model_fn, generator, batch["latents"],
            i2v_condition_type=i2v_condition_type,
            cond_latents=batch.get("cond_latents"), timestep=timestep,
            noise=noise)
        loss = loss.mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
