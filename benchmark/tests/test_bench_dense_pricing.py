"""D priced launch by launch: each call into the dense kernel's forward is
observed at the call, on the host, and priced at its own shape once the
window has closed; the calls observed have to be the launches the
program counted."""

import pytest
import torch

import _tiny
from benchmark import run, tracing
from benchmark.flops import wan as wan_flops

WAN_CELLS = [c for c in _tiny.CELLS if _tiny.family(c) == "wan"]


def _call(sq, skv, b=2, h=40, hd=128, cuda=True):
    return tracing.DenseCall(cuda, skv <= 512, b, h, sq, skv, hd, 2)


def _bound_ms(calls):
    n = sum(c.cuda for c in calls)
    short = sum(c.cuda and c.short for c in calls)
    return tracing.dense_totals(calls, {"d": n, "d_short": short})[1] * 1e3


def test_two_short_launches_are_priced_each_at_its_own_shape():
    """Wan2.1-I2V-14B's two cross-attentions of one block on one q [2, 40,
    32768, 128]: over 512 text keys, bound by its operations (0.695 ms),
    and over 257 image keys, bound by its bytes (0.404 ms)."""
    text, image = _call(32768, 512), _call(32768, 257)
    assert _bound_ms([text]) == pytest.approx(0.695, abs=5e-4)
    assert _bound_ms([image]) == pytest.approx(0.404, abs=5e-4)
    both = _bound_ms([text, image])
    assert both == pytest.approx(_bound_ms([text]) + _bound_ms([image]))
    assert both == pytest.approx(1.099, abs=1e-3)
    flop, _ = tracing.dense_totals([text, image], {"d": 2, "d_short": 2})
    assert flop == 4 * 2 * 40 * 32768 * (512 + 257) * 128


def test_a_call_on_the_cpu_launches_nothing():
    calls = [_call(256, 32, cuda=False), _call(256, 256, cuda=False)]
    assert tracing.dense_totals(calls, {"d": 0, "d_short": 0}) == (0.0, 0.0)


@pytest.mark.parametrize("launches", [{"d": 3, "d_short": 2},
                                      {"d": 2, "d_short": 1},
                                      {"d": 1, "d_short": 1}])
def test_launches_the_probe_did_not_observe_leave_d_unpriced(launches):
    calls = [_call(32768, 512), _call(32768, 257)]
    flop, bound = tracing.dense_totals(calls, launches)
    assert flop is None and bound is None
    ctx = {"device_ms": {"dense_kernel": 2.5}, "launches": launches,
           "d_flop": flop, "d_bound_s": bound, "gemm_flop": 1e12,
           "k1_flop": 0.0, "busy_s": 1.0, "window_s": 1.0,
           "peak_flops": 989e12}
    for metric in ("d_roofline", "step_mfu"):
        assert run.load_reader(metric)[0](ctx) is None


def _kept_probes(monkeypatch):
    made = []

    class Kept(tracing.Probe):
        def __init__(self, cuda):
            super().__init__(cuda)
            made.append(self)
    monkeypatch.setattr(tracing, "Probe", Kept)
    return made


@pytest.mark.parametrize("cell", WAN_CELLS)
def test_tiny_wan_runs_record_each_call_into_d(monkeypatch, cell):
    """Every call of the window is kept with its shape: per step, the
    cross-attention over the text keys in each block and, on a dense step,
    the self-attention over the padded tokens, as the cell's shapes give
    them; priced one by one they sum to those shapes' price per step."""
    made = _kept_probes(monkeypatch)
    res = _tiny.run_tiny(cell, trace=True, seconds=0.3)
    w, c = _tiny.tiny(cell)
    o = w["sampler"]
    steps = res["attempted"]
    # the window stays in the first clip: no warm-up step of a next clip
    assert 1 <= steps <= o["sampling_steps"] - w["warmup_steps"]
    (probe,) = made
    width, height = o["size"]
    latent = (c["in_dim"], (o["frame_num"] - 1) // 4 + 1, height // 8,
              width // 8)
    _, s_pad, lt = wan_flops.tokens(c, latent)
    n, hd = c["num_heads"], c["dim"] // c["num_heads"]
    dense = o["sa_drop_rates"][0] <= 0.25
    text = tracing.DenseCall(False, True, 2, n, s_pad, lt, hd, 4)
    self_attn = tracing.DenseCall(False, False, 2, n, s_pad, s_pad, hd, 4)
    per_step = [text] + ([self_attn] if dense else [])
    want = sorted(per_step * c["num_layers"] * steps)
    assert sorted(probe.d) == want
    as_launches = [call._replace(cuda=True) for call in probe.d]
    once = [call._replace(cuda=True) for call in per_step]
    counted = {"d": len(as_launches),
               "d_short": sum(call.short for call in as_launches)}
    flop, bound = tracing.dense_totals(as_launches, counted)
    f1, b1 = tracing.dense_totals(once, {"d": len(once),
                                         "d_short": 1})
    assert flop / steps == pytest.approx(c["num_layers"] * f1)
    assert bound / steps == pytest.approx(c["num_layers"] * b1)


def test_the_observation_keeps_the_counters_and_is_undone(monkeypatch):
    """The counters move as they would with no probe, and the call is the
    program's own again after ``end``."""
    from jenga_tpu_torch.ops import flash_attention as fa
    original = fa.dense_attention_forward

    def counted(q, k, v, **kw):
        # as a CUDA call counts its launch
        fa.dense_attention.launches += 1
        fa.dense_attention.short_launches += k.shape[2] <= fa.SHORT_KEYS
        return original(q, k, v, **kw)
    monkeypatch.setattr(fa, "dense_attention_forward", counted)
    q = torch.randn(1, 2, 256, 64)
    k_short, k_long = torch.randn(1, 2, 64, 64), torch.randn(1, 2, 640, 64)

    def calls():
        before = (fa.dense_attention.launches,
                  fa.dense_attention.short_launches)
        for k in (k_short, k_long, k_short):
            fa.dense_attention(q, k, k)
        return (fa.dense_attention.launches - before[0],
                fa.dense_attention.short_launches - before[1])

    plain = calls()
    probe = tracing.Probe(False)
    probe.arm()
    probe.begin()
    observed = calls()
    probe.end()
    assert observed == plain == (3, 2)
    assert [c.short for c in probe.d] == [True, False, True]
    assert [c.k_rows for c in probe.d] == [64, 640, 64]
    assert fa.dense_attention_forward is counted


def test_a_window_that_fails_undoes_the_observation():
    from jenga_tpu_torch.ops import flash_attention as fa
    from jenga_tpu_torch.ops import sparse_dispatch as sd
    before = (fa.dense_attention_forward, sd.block_sparse_attention)

    def breaker(cell):
        model = cell.sampler.model
        orig = model.head
        seen = []

        def head(*a, **kw):
            seen.append(1)
            if len(seen) > cell.warmup_steps:
                raise RuntimeError("planted")
            return orig(*a, **kw)
        model.head = head

    with pytest.raises(RuntimeError, match="planted"):
        _tiny.run_tiny(WAN_CELLS[0], trace=True, breaker=breaker)
    assert (fa.dense_attention_forward, sd.block_sparse_attention) == before
