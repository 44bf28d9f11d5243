"""The check that decides ``correct``, driven through whole runs of the
harness at small sizes on the CPU (the harness's look for a card is the
only part skipped), in every cell of ``BENCHMARK.json``:

  * the plain reference agrees with the port's CPU path in float32, far
    inside every limit;
  * with the timed path broken underneath, ``correct`` comes out false:
    a step that returns its state unchanged, one token of the velocity
    altered where the model produces it (each family's
    ``tiny/<family>.py`` plants them), and in the Wan cells half of the
    CFG batch left out (the null prompt's branch replaced by the
    prompt's). (No cell exchanges anything between chips.)
"""

import pytest
import torch

import _tiny

CELLS = _tiny.CELLS
WAN_CELLS = [c for c in CELLS if _tiny.family(c) == "wan"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell):
    res = _tiny.run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1
    # the card's clock readings are absent from a CPU run
    assert not {"sm_clock_mhz", "power_w", "throttle"} & set(res["device"])
    for name, c in res["checks"].items():
        assert c["value"] < 1e-4, name


def _output_edit(cell, edit):
    return lambda c: _tiny.module(_tiny.family(cell)).wrap_output(c, edit)


def _half_batch(v2):
    # the null prompt's half of the CFG batch left out: its row is the
    # prompt's
    return torch.cat([v2[:1], v2[:1]])


def _one_token(v2):
    v2 = v2.clone()
    v2[..., 1, 3, 5] += 4.0 * v2.std()
    return v2


@pytest.mark.parametrize("cell", CELLS)
def test_state_unchanged_fails(monkeypatch, cell):
    _tiny.module(_tiny.family(cell)).state_unchanged(monkeypatch)
    res = _tiny.run_tiny(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", WAN_CELLS)
def test_half_batch_fails(cell):
    res = _tiny.run_tiny(cell, breaker=_output_edit(cell, _half_batch))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_one_token_altered_fails(cell):
    res = _tiny.run_tiny(cell, breaker=_output_edit(cell, _one_token))
    assert not res["correct"], res["checks"]
    assert any(not c["value"] <= c["limit"]
               for k, c in res["checks"].items() if "worst_token" in k)
