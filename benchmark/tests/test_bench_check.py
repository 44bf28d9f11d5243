"""The check that decides ``correct``, driven through whole runs of the
harness at small sizes on the CPU (the harness's look for a card is the
only part skipped):

  * the plain reference agrees with the port's CPU path in float32, far
    inside every limit, in each cell;
  * with the timed path broken underneath, ``correct`` comes out false:
    a step that returns its state unchanged, half of the CFG batch left
    out (the null prompt's branch replaced by the prompt's), one token of
    the velocity altered where the model produces it. (No cell exchanges
    anything between chips.)
"""

import pytest
import torch

import _tiny

CELLS = [(_tiny.wan, "wan13b-480p-carved"), (_tiny.wan, "wan13b-480p-dense"),
         (_tiny.hyvideo, "hy-720p125f-carved")]


@pytest.mark.parametrize("make,cell", CELLS, ids=[c for _, c in CELLS])
def test_reference_agrees_with_the_port(make, cell):
    res = _tiny.run_tiny(make, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1
    for name, c in res["checks"].items():
        assert c["value"] < 1e-4, name


def _state_unchanged(monkeypatch, family):
    if family == "wan":
        from jenga_tpu_torch.diffusion import unipc
        orig = unipc.unipc_step

        def step(schedule, state, velocity, sample):
            new_state, _ = orig(schedule, state, velocity, sample)
            return new_state, sample
        monkeypatch.setattr(unipc, "unipc_step", step)
    else:
        from jenga_tpu_torch.diffusion.flow_match import FlowMatchSchedule
        monkeypatch.setattr(FlowMatchSchedule, "step",
                            lambda self, i, sample, velocity: sample.float())
    return None


def _wrap_head(edit):
    def breaker(cell):
        model = cell.sampler.model
        orig = model.head

        def head(*a, **kw):
            return edit(orig(*a, **kw))
        model.head = head
    return breaker


def _half_batch(v2):
    # the null prompt's half of the CFG batch left out: its row is the
    # prompt's
    return torch.cat([v2[:1], v2[:1]])


def _one_token(v2):
    v2 = v2.clone()
    v2[..., 1, 3, 5] += 4.0 * v2.std()
    return v2


@pytest.mark.parametrize("make,cell", CELLS, ids=[c for _, c in CELLS])
def test_state_unchanged_fails(monkeypatch, make, cell):
    _state_unchanged(monkeypatch, "wan" if make is _tiny.wan else "hy")
    res = _tiny.run_tiny(make, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["wan13b-480p-carved", "wan13b-480p-dense"])
def test_half_batch_fails(cell):
    res = _tiny.run_tiny(_tiny.wan, cell, breaker=_wrap_head(_half_batch))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("make,cell", CELLS, ids=[c for _, c in CELLS])
def test_one_token_altered_fails(make, cell):
    res = _tiny.run_tiny(make, cell, breaker=_wrap_head(_one_token))
    assert not res["correct"], res["checks"]
    assert any(not c["value"] <= c["limit"]
               for k, c in res["checks"].items() if "worst_token" in k)
