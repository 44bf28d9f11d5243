"""Batches and prompt extension through the port's CLI against the JAX
CLI on the CPU.

``batch.py`` is a copy held by ``test_torch_host_modules.COPIES``. Here
each new flag of the JAX CLI (``--prompt-file`` json and txt,
``--remain-list``, ``--chunk-num``/``--cur-id``, ``--out-dir``,
``--vbench``, ``--vbench-samples``, ``--vbench-dimension``, the
``--prompt-extend-*`` flags) runs through both CLIs' ``main`` with the
sampler replaced by a recorder: the ``(prompt, seed)`` calls in order,
the files written (time stamps masked) and what is printed must be the
JAX handler's. Prompt extension uses a stub local expander or a stub
transport, never a model or the network. One port-only run of
``wan-t2v --tiny --device cpu --vbench`` checks the layout, the seeds and
the resume on a real model; a two-rank gloo run checks that every rank
generates and only rank 0 writes.
"""

import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from jenga_tpu import cli as jcli
from jenga_tpu.pipelines import hyvideo_i2v as jhy_i2v
from jenga_tpu.text import prompt_extend as jpe
from jenga_tpu_torch import cli as tcli
from jenga_tpu_torch.pipelines import hyvideo_i2v as thy_i2v
from jenga_tpu_torch.text import prompt_extend as tpe

ROOT = pathlib.Path(__file__).resolve().parent.parent
ITEMS = [{"prompt_en": "a dog runs", "id": 3},
         {"prompt_en": "city at night", "id": 7},
         {"prompt_en": "a/slash prompt", "id": 12},
         {"prompt_en": "no id here"},
         {"prompt_en": "waves", "id": 20}]
INFO = [{"prompt_en": "a dog runs", "dimension": ["subject_consistency"]},
        {"prompt_en": "city at night", "dimension": ["scene"]},
        {"prompt_en": "a/slash prompt", "dimension": ["scene", "style"]},
        {"not_a": "prompt"}]


class _Recorder:
    """Both samplers' prompt entry points: ``predict_prompt`` (HY) and
    ``generate_prompt`` (Wan) record ``(prompt, seed)`` and return a
    16-channel latent whose values carry the seed."""

    text_encoder = t5 = True

    def __init__(self):
        self.calls = []

    def _out(self, prompt, opts):
        self.calls.append((prompt, opts.seed))
        return torch.full((16, 2, 3, 4), float(opts.seed))

    def predict_prompt(self, prompt, opts, negative_prompt=None,
                       decode=True):
        return self._out(prompt, opts)

    def generate_prompt(self, prompt, opts, negative_prompt="",
                        decode=True):
        return self._out(prompt, opts)


def _files(tmp_path):
    """The prompt lists of the cases, written once per test."""
    (tmp_path / "items.json").write_text(json.dumps(ITEMS))
    # a resume filter reads every item's id
    (tmp_path / "ids.json").write_text(json.dumps(
        [item for item in ITEMS if "id" in item]))
    (tmp_path / "items.txt").write_text(
        "first prompt\n\n  second prompt  \nthird\nfourth\n")
    (tmp_path / "keep.json").write_text(json.dumps([7, 20, 99]))
    (tmp_path / "full_info.json").write_text(json.dumps(INFO))
    return tmp_path


def _mask(text: str, out: str) -> str:
    text = text.replace(out, "OUT")
    return re.sub(r"\d{8}-\d{6}", "STAMP", text)


def _run(pkg, argv, tmp_path, stubs=()):
    """``main(argv)`` of one CLI with the recorder as the sampler: (calls,
    sorted names in the out dir, printed lines), paths and time stamps
    masked."""
    cli = jcli if pkg == "jax" else tcli
    out = tmp_path / f"out_{pkg}"
    rec = _Recorder()
    extra = (["--cpu", "--no-compile-cache"] if pkg == "jax"
             else ["--device", "cpu"])
    argv = [a.replace("OUT", str(out)).replace("DIR", str(tmp_path))
            for a in argv]
    out.mkdir(exist_ok=True)
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(cli, "_hy_sampler",
                                              lambda *a, **k: rec))
        stack.enter_context(mock.patch.object(cli, "_wan_sampler",
                                              lambda *a, **k: rec))
        for stub in stubs:
            stack.enter_context(stub(pkg))
        stack.enter_context(contextlib.redirect_stdout(buf))
        try:
            cli.main(argv + ["--save-path", str(out / "single.npy")]
                     + extra)
        except SystemExit as e:
            rec.calls.append(("exit", str(e.code)))
    names = sorted(_mask(n, str(out)) for n in os.listdir(out))
    lines = [_mask(line, str(out)) for line in buf.getvalue().splitlines()
             if not line.startswith('{"gen_time_s"')]
    return rec.calls, names, lines


def _same_as_jax(argv, tmp_path, stubs=()):
    _files(tmp_path)
    want = _run("jax", argv, tmp_path, stubs)
    got = _run("port", argv, tmp_path, stubs)
    print(f"{argv}: {got}")
    assert got == want
    return got


BATCH_CASES = {
    "json": ["--prompt-file", "DIR/items.json"],
    "txt": ["--prompt-file", "DIR/items.txt"],
    "remain_list": ["--prompt-file", "DIR/ids.json", "--remain-list",
                    "DIR/keep.json"],
    "chunks": ["--prompt-file", "DIR/items.json", "--chunk-num", "2",
               "--cur-id", "1"],
    "chunks_txt": ["--prompt-file", "DIR/items.txt", "--chunk-num", "3",
                   "--cur-id", "0"],
    "seed": ["--prompt-file", "DIR/items.json", "--seed", "41"],
    "vbench": ["--prompt-file", "DIR/full_info.json", "--vbench"],
    "vbench_samples": ["--prompt-file", "DIR/full_info.json", "--vbench",
                       "--vbench-samples", "2", "--seed", "9"],
    "vbench_dimension": ["--prompt-file", "DIR/full_info.json", "--vbench",
                         "--vbench-samples", "1", "--vbench-dimension",
                         "scene"],
    "vbench_chunks": ["--prompt-file", "DIR/full_info.json", "--vbench",
                      "--vbench-samples", "2", "--chunk-num", "2",
                      "--cur-id", "1"],
}


@pytest.mark.parametrize("cmd", ["hyvideo-t2v", "wan-t2v"])
@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_batch_flags_match_jax(tmp_path, case, cmd):
    """Each batch flag: the same generations in the same order at the
    same seeds, the same files under ``--out-dir`` and the same log."""
    calls, names, _ = _same_as_jax(
        [cmd, "--latents-only", "--out-dir", "OUT", *BATCH_CASES[case]],
        tmp_path)
    assert calls and len(names) == len(calls)
    assert "single.npy" not in names


@pytest.mark.parametrize("vbench", [False, True])
def test_batch_resume_matches_jax(tmp_path, vbench):
    """Files already in ``--out-dir`` (an id-stamped one, a legacy
    ``{id}.npy`` one and one of an id that is an underscore-prefix of
    another; VBench's ``{prompt}-{i}``) are skipped alike, and a second
    run skips everything."""
    argv = ["wan-t2v", "--latents-only", "--out-dir", "OUT",
            "--prompt-file", "DIR/" + ("full_info.json" if vbench
                                       else "items.json")]
    if vbench:
        argv += ["--vbench", "--vbench-samples", "2"]
    for pkg in ("jax", "port"):
        out = tmp_path / f"out_{pkg}"
        out.mkdir()
        for name in (["city at night-1.npy"] if vbench else
                     ["0003_20250101-120000_seed0_x.npy", "0007.npy",
                      "0012_b_20250101-120000_seed0_x.npy"]):
            (out / name).write_bytes(b"")
    first = _same_as_jax(argv, tmp_path)
    # ids 3 and 7 skip, and the id-less fourth item, whose id is its
    # index among the kept items (0003); 12 ("0012_b_..." is another id's)
    # and 20 run
    assert len(first[0]) == (5 if vbench else 2)
    second = _same_as_jax(argv, tmp_path)
    assert second[0] == [] and second[1] == first[1]


def _stub_local(pkg):
    """A local expander that answers ``EXT[<mode's first word>] <user>``
    without loading anything."""
    mod = jpe if pkg == "jax" else tpe

    class Local:
        def __init__(self, model_dir, *a, **k):
            self.model_dir = model_dir

        def __call__(self, system, user, image=None):
            seen = "img " if image is not None else ""
            head = system.split()[0]
            return f"  EXT[{head}] {seen}{user} ({self.model_dir})"

    return _patch_both(mod, {"LocalLLMExpander": Local,
                             "LocalVLExpander": Local})


@contextlib.contextmanager
def _patch_both(mod, attrs):
    with contextlib.ExitStack() as stack:
        for name, value in attrs.items():
            stack.enter_context(mock.patch.object(mod, name, value))
        yield


def _stub_api(pkg):
    """The API expander's HTTPS post replaced by a recorder that answers
    in the DashScope dialect."""
    mod = jpe if pkg == "jax" else tpe

    def post(url, headers, body, timeout):
        msg = json.loads(body)
        user = msg["messages"][1]["content"]
        return json.dumps({"output": {"text": f"API[{msg['model']}] "
                                              f"{user}"}}).encode()

    return mock.patch.object(mod.APIExpander, "_http_post",
                             staticmethod(post))


EXTEND_CASES = {
    "local_t2v": ["--prompt-extend-model", "DIR/lm"],
    "local_rewrite": ["--prompt-extend-model", "DIR/lm",
                      "--prompt-extend-mode", "rewrite"],
    "local_master": ["--prompt-extend-model", "DIR/lm",
                     "--prompt-extend-mode", "master"],
    "local_i2v_mode": ["--prompt-extend-model", "DIR/lm",
                       "--prompt-extend-mode", "i2v"],
    "api": ["--prompt-extend-method", "api"],
    "api_model": ["--prompt-extend-method", "api",
                  "--prompt-extend-api-model", "qwen-max"],
    "vl_without_image": ["--prompt-extend-model", "DIR/lm",
                         "--prompt-extend-mode", "vl"],
    "none": [],
}


@pytest.mark.parametrize("cmd", ["hyvideo-t2v", "wan-t2v"])
@pytest.mark.parametrize("case", list(EXTEND_CASES))
def test_prompt_extend_flags_match_jax(tmp_path, case, cmd):
    """A single run with each ``--prompt-extend-*`` setting: the prompt
    the sampler gets, the printed extension, and ``vl`` without an image
    exiting with JAX's message."""
    calls, names, lines = _same_as_jax(
        [cmd, "--latents-only", "--prompt", "a red fox", "--seed", "4",
         *EXTEND_CASES[case]], tmp_path, stubs=(_stub_local, _stub_api))
    if case == "vl_without_image":
        assert calls == [("exit", "--prompt-extend-mode vl needs an input "
                          "image (--i2v-image-path / --image)")]
    elif case == "none":
        assert calls == [("a red fox", 4)] and names == ["single.npy"]
    else:
        assert calls[0][0] != "a red fox" and "a red fox" in calls[0][0]
        assert f"extended prompt: {calls[0][0]}" in lines


def test_prompt_extend_ignored_in_a_batch(tmp_path):
    """As in JAX, a batch generates the list's prompts unextended."""
    calls, _, _ = _same_as_jax(
        ["wan-t2v", "--latents-only", "--out-dir", "OUT", "--prompt-file",
         "DIR/items.txt", "--prompt-extend-model", "DIR/lm"], tmp_path,
        stubs=(_stub_local,))
    assert [c[0] for c in calls] == ["first prompt", "second prompt",
                                     "third", "fourth"]


class _Captured(Exception):
    pass


@pytest.mark.parametrize("mode", ["t2v", "vl"])
def test_hyvideo_i2v_extends_the_prompt(tmp_path, mode):
    """``hyvideo-i2v`` extends the prompt before encoding it, as JAX does
    (``vl`` with the command's image): the same printed extension, then
    the trajectory (stopped at its entry)."""
    from PIL import Image
    img = tmp_path / "img.png"
    Image.fromarray(np.zeros((64, 48, 3), np.uint8)).save(img)
    printed = {}
    for pkg, cli, target in (
            ("jax", jcli, (jhy_i2v.HYVideoI2VPipeline, "generate_i2v")),
            ("port", tcli, (thy_i2v.HYVideoI2VPipeline, "generate_i2v"))):
        extra = (["--cpu", "--no-compile-cache"] if pkg == "jax"
                 else ["--device", "cpu"])
        buf = io.StringIO()
        with _stub_local(pkg), mock.patch.object(
                *target, side_effect=_Captured), \
                contextlib.redirect_stdout(buf), pytest.raises(_Captured):
            cli.main(["hyvideo-i2v", "--tiny", "--latents-only",
                      "--video-size", "64", "64", "--video-length", "9",
                      "--prompt", "a lamp", "--i2v-image-path", str(img),
                      "--prompt-extend-model", "lm",
                      "--prompt-extend-mode", mode] + extra)
        printed[pkg] = [line for line in buf.getvalue().splitlines()
                        if line.startswith("extended prompt")]
    assert printed["port"] == printed["jax"] != []
    assert ("img " in printed["port"][0]) == (mode == "vl")


def test_wan_i2v_extends_the_prompt(tmp_path):
    """``wan-i2v`` with an image and T5 hands ``generate_image`` the
    extended prompt, as JAX does."""
    from PIL import Image
    img = tmp_path / "img.png"
    Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(img)
    seen = {}
    for pkg, cli in (("jax", jcli), ("port", tcli)):
        rec = _Recorder()

        def generate_image(image, prompt, opts, negative_prompt="",
                           decode=True):
            seen[pkg] = (prompt, opts.seed, image.shape)
            return torch.zeros((16, 1, 2, 2))

        rec.generate_image = generate_image
        extra = (["--cpu", "--no-compile-cache"] if pkg == "jax"
                 else ["--device", "cpu"])
        with _stub_local(pkg), mock.patch.object(
                cli, "_wan_sampler", lambda *a, **k: rec), \
                contextlib.redirect_stdout(io.StringIO()):
            cli.main(["wan-i2v", "--latents-only", "--image", str(img),
                      "--ckpt-dir", str(tmp_path), "--prompt", "a boat",
                      "--seed", "2", "--prompt-extend-model", "lm",
                      "--save-path", str(tmp_path / f"{pkg}.npy")] + extra)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0].startswith("EXT[")


def test_main_logs_the_arguments_on_rank_zero(monkeypatch):
    """``main`` hands every parsed flag to ``utils.logging.log_args`` on a
    logger gated by torchrun's ``RANK`` (JAX reads its process index)."""
    seen = []
    for rank in ("0", "3"):
        monkeypatch.setenv("RANK", rank)
        with mock.patch.object(tcli, "run_wan_t2v", lambda a: None), \
                mock.patch("jenga_tpu_torch.utils.logging.get_logger",
                           lambda rank: ("logger", rank)), \
                mock.patch("jenga_tpu_torch.utils.logging.log_args",
                           lambda logger, args: seen.append(
                               (logger, sorted(vars(args))))):
            tcli.main(["wan-t2v", "--vbench", "--out-dir", "x"])
    assert [s[0] for s in seen] == [("logger", 0), ("logger", 3)]
    jargs = vars(jcli.build_parser().parse_args(["wan-t2v"]))
    new = {"prompt_file", "remain_list", "chunk_num", "cur_id", "out_dir",
           "vbench", "vbench_samples", "vbench_dimension",
           "prompt_extend_model", "prompt_extend_mode",
           "prompt_extend_method", "prompt_extend_api_model"}
    assert new <= set(seen[0][1]) and new <= set(jargs)


# ------------------------------------------------------- port end to end

TINY = ["wan-t2v", "--tiny", "--device", "cpu", "--latents-only",
        "--infer-steps", "2", "--video-size", "64", "64", "--video-length",
        "9"]


def test_vbench_end_to_end_on_the_tiny_model(tmp_path):
    """``wan-t2v --tiny --device cpu --vbench`` on a real model: the
    protocol's layout ({prompt}-{i}.npy, the dimension filter), samples
    at distinct seeds differing, sample 0 bit for bit a single run at
    ``--seed``, and a second run that writes nothing."""
    info = tmp_path / "full_info.json"
    info.write_text(json.dumps(INFO))
    out = tmp_path / "videos"
    argv = TINY + ["--vbench", "--vbench-samples", "2", "--seed", "5",
                   "--vbench-dimension", "scene", "--prompt-file",
                   str(info), "--out-dir", str(out)]
    tcli.main(argv)
    expect = {"city at night-0.npy", "city at night-1.npy",
              "a slash prompt-0.npy", "a slash prompt-1.npy"}
    assert set(os.listdir(out)) == expect
    lat = {n: np.load(out / n) for n in expect}
    for a in lat.values():
        assert a.shape == (16, 3, 8, 8) and np.isfinite(a).all()
    assert not np.array_equal(lat["city at night-0.npy"],
                              lat["city at night-1.npy"])
    single = tmp_path / "single.npy"
    tcli.main(TINY + ["--prompt", "city at night", "--seed", "5",
                      "--save-path", str(single)])
    np.testing.assert_array_equal(np.load(single),
                                  lat["city at night-0.npy"])
    mtimes = {n: os.path.getmtime(out / n) for n in expect}
    tcli.main(argv)
    assert {n: os.path.getmtime(out / n) for n in expect} == mtimes


_RANK = """
import json, sys, time, torch
from jenga_tpu_torch import cli
from jenga_tpu_torch.parallel.mesh import init_distributed
rank, store, items, out = int(sys.argv[1]), *sys.argv[2:5]
init_distributed("cpu", init_method=f"file://{store}", world_size=2,
                 rank=rank)
if sys.argv[5:] == ["fail"]:        # rank 0's first write raises
    save, writes = cli._save_output, []
    def failing(path, out, latents_only=False):
        writes.append(path)
        if len(writes) == 1:
            raise OSError("disk full")
        save(path, out, latents_only)
    cli._save_output = failing
args = cli.build_parser().parse_args(
    ["wan-t2v", "--latents-only", "--prompt-file", items, "--out-dir", out,
     "--device", "cpu"])
calls = []
def gen(prompt, seed=None):
    calls.append(prompt)
    return torch.full((16, 1, 2, 2), float(len(calls)))
if rank == 1:       # rank 0 reaches its first write first
    time.sleep(2)
cli._maybe_run_batch(args, gen)
print(json.dumps(calls))
"""


def _two_ranks(tmp_path, *extra):
    """Both ranks' (stdout, stderr) of ``_RANK`` over a batch with a
    repeated id, each rank's calls, and the output directory."""
    items = tmp_path / "items.json"
    items.write_text(json.dumps([{"prompt_en": "p one", "id": 1},
                                 {"prompt_en": "p two", "id": 2},
                                 {"prompt_en": "p one again", "id": 1}]))
    out = tmp_path / "out"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
         str(items), str(out), *extra], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        res = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, res):
        assert p.returncode == 0, e[-2000:]
    calls = [json.loads(o.strip().splitlines()[-1]) for o, _ in res]
    return res, calls, out


def test_batch_under_two_ranks(tmp_path):
    """Two gloo ranks run one batch with a repeated id, rank 1 starting
    late: both generate the same prompts (the first not skipped by the
    late rank, the repeat skipped on both after rank 0 wrote the first),
    only rank 0 prints and writes."""
    res, calls, out = _two_ranks(tmp_path)
    assert calls[0] == calls[1] == ["p one", "p two"]
    assert len(os.listdir(out)) == 2
    assert "saved" in res[0][0] and "saved" not in res[1][0]


def test_batch_under_two_ranks_when_rank_zero_save_fails(tmp_path):
    """Rank 0's first write raises: the batch logs it and goes on, and
    both ranks still meet at that item's barrier, so they finish with
    the same calls (the failed id generated again, since nothing of it
    was written) and rank 0 writes the other two."""
    res, calls, out = _two_ranks(tmp_path, "fail")
    assert calls[0] == calls[1] == ["p one", "p two", "p one again"]
    assert "[0001] FAILED: OSError: disk full" in res[0][0]
    assert sorted(n.split("_")[0] for n in os.listdir(out)) == ["0001", "0002"]
