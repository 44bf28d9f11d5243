"""The benchmark's cells at small sizes for CPU tests: every cell of
``BENCHMARK.json``, from its own files, cut down by its family's tiny
module ``tiny/<family>.py`` (``tiny``, and the faults the check tests
plant: ``state_unchanged``, ``wrap_output``)."""

import copy
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
_MODULES = {}


def family(cell: str) -> str:
    return run.load_cell(cell)[1]["family"]


def module(name: str):
    """``tiny/<name>.py``, found by the family's name."""
    if name not in _MODULES:
        path = pathlib.Path(__file__).parent / "tiny" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_tiny_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[name] = mod
    return _MODULES[name]


def tiny(cell: str, dtype: str = "float32"):
    """(workload, config) of ``cell`` at its family's tiny size."""
    w, c = run.load_cell(cell)
    return module(c["family"]).tiny(copy.deepcopy(w), dict(c), dtype)


def run_tiny(cell, seed=1234567, seconds=0.5, trace=False, breaker=None,
             control=None, dtype="float32"):
    w, c = tiny(cell, dtype)
    return run.run_cell(cell, seed, seconds, trace, "cpu", workload=w,
                        config=c, breaker=breaker, control=control,
                        metrics=run.layer_metrics(cell) if trace else [])


def wrap_model_head(cell, edit):
    """``edit`` applied to the output of the cell's model's head, where a
    DiT produces its velocity."""
    model = cell.sampler.model
    orig = model.head

    def head(*a, **kw):
        return edit(orig(*a, **kw))
    model.head = head
