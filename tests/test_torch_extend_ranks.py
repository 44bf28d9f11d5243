"""Prompt extension under two gloo ranks (``cli._maybe_extend_prompt``).

The ranks run the ``extend`` suite of ``tests/_torch_sp_worker.py``: the
stub transport and the stub local expander answer each rank with another
text, so a rank that extended for itself would show. Rank 0 alone must
build the expander, make the request and print the extension; both ranks
must return its text, or, when it fails, exit with the same message
instead of one of them waiting in a collective. Each case is held to
the same case run in this process without a group (world 1), where the
port behaves as before: the expander built, the text printed. No JAX
here: the JAX CLI has no rank gate, and its single-process behaviour is
held to the port's in ``tests/test_torch_batch.py``.
"""

import pytest

import _torch_sp_worker as W

TIMEOUT = 60        # seconds for both ranks; a rank left waiting fails it
API_FAILED = ("prompt extension failed on rank 0: RuntimeError: "
              "prompt-extend API failed after 4 attempts: ConnectionError: "
              "endpoint unreachable")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results per case, and the world-1 results."""
    d = str(tmp_path_factory.mktemp("extend"))
    procs = W.start_ranks("extend", 2, d)
    try:
        world1 = {n: W.SUITES["extend"][n](None, None, d)
                  for n in W.EXTEND_ARGS}
    finally:
        ranks = W.finish_ranks(procs, d, TIMEOUT)[0]
    return ranks, world1


def _text(x):
    return str(x[()]) if x is not None else None


@pytest.mark.parametrize("name,text", [
    ("api", "api text of rank 0"), ("local", "local text of rank 0"),
    ("vl_api", "api text of rank 0")])
def test_rank0_extends_and_every_rank_takes_its_text(runs, name, text):
    """Both ranks return rank 0's text; rank 0 alone built an expander,
    made the one request (``vl``: read the image) and printed the line,
    exactly as the world-1 run does."""
    ranks, world1 = runs
    r0, r1, w1 = ranks[0][name], ranks[1][name], world1[name]
    assert _text(r0["prompt"]) == _text(r1["prompt"]) == text
    assert _text(w1["prompt"]) == text
    api = name != "local"
    for rec in (r0, w1):
        assert int(rec["expanders"]) == 1
        assert int(rec["requests"]) == int(api)
        assert int(rec["image_parts"]) == int(name == "vl_api")
        assert _text(rec["stdout"]) == f"extended prompt: {text}\n"
    assert [int(r1[k]) for k in ("expanders", "requests", "image_parts")] \
        == [0, 0, 0]
    assert _text(r1["stdout"]) == ""


@pytest.mark.parametrize("name,message", [
    ("api_fails", API_FAILED),
    ("vl_without_image", "--prompt-extend-mode vl needs an input image "
                          "(--i2v-image-path / --image)")])
def test_rank0_failure_ends_every_rank(runs, name, message):
    """Rank 0's failure reaches rank 1 through the broadcast: both exit
    with the same message within the ranks' time limit (none waits in a
    collective), and rank 1 made no request. At world 1 the API's error
    propagates as it is, and ``vl`` without an image exits with JAX's
    message."""
    ranks, world1 = runs
    r0, r1 = ranks[0][name], ranks[1][name]
    assert _text(r0.get("exit")) == _text(r1.get("exit")) == message
    assert "prompt" not in r0 and "prompt" not in r1
    assert int(r1["requests"]) == int(r1["expanders"]) == 0
    assert int(r0["requests"]) == (4 if name == "api_fails" else 0)
    if name == "vl_without_image":
        assert _text(world1[name]["exit"]) == message
    else:
        assert "rank 0: " + _text(world1[name]["error"]) in message
