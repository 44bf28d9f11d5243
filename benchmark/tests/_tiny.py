"""Small configurations of the benchmark's cells for CPU tests: the
cells' own files with the widths, depth, frames and steps cut down."""

import copy
import sys
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402


def wan(cell="wan13b-480p-carved", dtype="float32"):
    w, c = run.load_cell(cell)
    c = dict(c, dim=256, ffn_dim=512, num_heads=2, num_layers=2,
             text_dim=64, text_len=32, dtype=dtype)
    w = copy.deepcopy(w)
    w["sampler"].update(size=[384, 384], frame_num=17, sampling_steps=12)
    w["warmup_steps"] = min(w["warmup_steps"], 2)
    w["text_tokens"] = [8, 20]
    return w, c


def hyvideo(cell="hy-720p125f-carved", dtype="float32"):
    w, c = run.load_cell(cell)
    c = dict(c, hidden_size=256, heads_num=2, double_blocks=1,
             single_blocks=2, text_states_dim=64, text_states_dim_2=32,
             dtype=dtype)
    w = copy.deepcopy(w)
    w["sampler"].update(size=[256, 128], video_length=33,
                        num_inference_steps=6)
    w["text_tokens"] = [256, 40]
    return w, c


def run_tiny(make, cell, seed=1234567, seconds=0.5, trace=False,
             breaker=None, control=None, dtype="float32"):
    w, c = make(cell, dtype)
    return run.run_cell(cell, seed, seconds, trace, "cpu", workload=w,
                        config=c, breaker=breaker, control=control,
                        metrics=run.layer_metrics(cell) if trace else [])
