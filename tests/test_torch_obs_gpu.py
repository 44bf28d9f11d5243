"""The sync counter of ``jenga_tpu_torch.obs`` on a CUDA card (skipped
without one): a planted ``.item()`` and a ``torch.as_tensor`` of a Python
int onto the card inside a span each count one sync under it, and
switching tracing off leaves the sync debug mode as it was. This file
imports no JAX, so it also runs on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -q tests/test_torch_obs_gpu.py
"""

import pytest
import torch

from jenga_tpu_torch import obs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the sync debug mode is CUDA's")
    obs.disable()
    yield torch.device("cuda")
    obs.disable()


def _gained(before):
    after = obs.syncs()
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("plant", ["item", "as_tensor"])
def test_a_planted_sync_counts_once_under_its_span(cuda_device, plant):
    x = torch.ones(4, device=cuda_device)
    torch.cuda.synchronize()
    before = obs.syncs()
    obs.enable()
    with obs.span("outer"):
        y = x * 2               # an asynchronous launch: no sync
        with obs.span("planted"):
            if plant == "item":
                y.sum().item()
            else:
                torch.as_tensor(7, device=cuda_device)
    obs.disable()
    assert _gained(before) == {"planted": 1}


@pytest.mark.gpu
def test_tracing_off_leaves_the_sync_debug_mode(cuda_device):
    torch.cuda.set_sync_debug_mode("default")
    obs.enable()
    assert torch.cuda.get_sync_debug_mode() == 1
    obs.disable()
    assert torch.cuda.get_sync_debug_mode() == 0
    before = obs.syncs()
    with obs.span("off"):
        torch.ones(2, device=cuda_device).sum().item()
    assert _gained(before) == {}
