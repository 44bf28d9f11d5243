"""Time ``chip_smoke.py``'s phase-2 kernel cases (K1, K1m, K2, D and D's
backward) of two checkouts with one timer, in the order A, B, B, A, on one
card.

Each run is a fresh process in that checkout's root: it builds the
checkout's kernels, then runs its ``phase_kernel_cases`` with the
checkout's own ``time_ms`` replaced by this tree's (``_common.timed``:
CUDA events over a window of at least 50 ms), and the flex_attention
yardstick switched off where the checkout has one. The table gives each
case's ms in the four runs and B's mean against A's, then the cases only
B has with B's two times. A backward case's record (``dense_attn_bwd``)
also gives its dK|dV and dQ kernels' ms as the rows ``dense_attn_bwd.dkv``
and ``.dq`` (a checkout's own per-kernel timing: CUDA events on the route
over 512 keys, the profiler's device time of the short-key call's kernels;
the pair's ms, through the wrapper, is the shared timer's).

    python -m jenga_tpu_torch.tools.kernel_cases_ab --a checkout/parent \\
        --b .

With ``--phase train`` each run is the checkout's phase 16 instead (Wan
2.1-T2V-1.3B LoRA fine-tuning at full width and depth: 3 dense and 2
carved steps, each on the host clock around a synchronized step), and
the rows are each step's seconds and LoRA gradient norm.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

from . import _common
from ._common import gpu_line, resolve_device

__all__ = ["run"]

_CHILD = """
import json, math, sys, time
import torch
sys.path.insert(0, {root!r})
import chip_smoke as s
{timed_src}
s.time_ms = lambda fn, reps: timed(fn, reps, torch.device("cuda"))[0]
if hasattr(s, "_flex_ms"):
    s._flex_ms = lambda rec, *a, **kw: None
torch.backends.cuda.matmul.allow_tf32 = False
s.phase_toolchain()
s.phase_kernel_cases()
"""

_TRAIN_CHILD = """
import json, sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke as s
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
s.phase_toolchain()
r = s.phase_train_wan()
print("TRAIN " + json.dumps({{k: r[k]["steps"] for k in ("dense", "carved")}}))
"""


def _key(rec):
    return (rec["kernel"], rec["case"], rec.get("mode"),
            rec.get("fixed_max"))


def _one(root: str, timeout: int, phase: str = "kernels"):
    """{case key: ms} of one run of the phase-2 cases in ``root``, or with
    ``phase="train"`` {(kind, step, "s" or "grad_norm"): value} of its
    phase 16."""
    if phase == "train":
        code = _TRAIN_CHILD.format(root=os.path.abspath(root))
    else:
        code = _CHILD.format(
            root=os.path.abspath(root),
            timed_src=(f"MIN_WINDOW_MS = {_common.MIN_WINDOW_MS!r}\n"
                       f"MAX_REPS = {_common.MAX_REPS!r}\n"
                       + inspect.getsource(_common.timed)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"phase 2 in {root} failed "
                           f"(rc {proc.returncode}):\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    out = {}
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("TRAIN "):
            for kind, steps in json.loads(line[6:]).items():
                for i, st in enumerate(steps):
                    for field in ("s", "grad_norm"):
                        out[("lora_step", kind, i, field)] = st[field]
        elif line.startswith("{") and '"case"' in line:
            rec = json.loads(line)
            out[_key(rec)] = rec["ms"]
            # D's backward cases: each kernel's ms beside the pair's
            for part in ("dkv", "dq"):
                if rec.get(f"{part}_ms") is not None:
                    out[(f"{rec['kernel']}.{part}",) + _key(rec)[1:]] = \
                        rec[f"{part}_ms"]
    return out


def run(a: str, b: str, *, timeout: int = 900, phase: str = "kernels"):
    """Returns {"order": [...], "cases": {key: [ms per run]}, "b_only":
    {key: [ms of B's two runs]}} for the runs A, B, B, A: the cases both
    checkouts have, and those only B has."""
    resolve_device("cuda")
    order = [("A", a), ("B", b), ("B", b), ("A", a)]
    runs = [_one(root, timeout, phase) for _, root in order]
    common = [k for k in runs[1] if all(k in r for r in runs)]
    b_only = [k for k in runs[1] if k not in runs[0] and k in runs[2]]
    return {"order": [name for name, _ in order],
            "cases": {k: [r[k] for r in runs] for k in common},
            "b_only": {k: [runs[1][k], runs[2][k]] for k in b_only}}


def print_table(res):
    print(f"runs: {' '.join(res['order'])}")
    for key, ms in res["cases"].items():
        a = (ms[0] + ms[3]) / 2
        b = (ms[1] + ms[2]) / 2
        cells = " ".join(f"{x:10.6g}" for x in ms)
        print(f"{' '.join(str(x) for x in key):60s} {cells}  B/A "
              f"{b / a - 1:+.2%}", flush=True)
    for key, ms in res.get("b_only", {}).items():
        cells = " ".join(f"{x:10.6g}" for x in ms)
        print(f"{' '.join(str(x) for x in key):60s} B only: {cells}",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (the parent)")
    ap.add_argument("--b", default=".", help="checkout B (the change)")
    ap.add_argument("--phase", choices=("kernels", "train"),
                    default="kernels",
                    help="phase 2's kernel cases, or phase 16's LoRA steps")
    args = ap.parse_args()
    print(gpu_line(), flush=True)
    print_table(run(args.a, args.b, phase=args.phase))
    print(gpu_line(), flush=True)


if __name__ == "__main__":
    main()
