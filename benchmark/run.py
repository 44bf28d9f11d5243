#!/usr/bin/env python3
"""The benchmark of ``jenga_tpu_torch`` on one or more NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process runs one cell once, from the root of a checkout. The cell
``benchmark/workloads/<cell>.json`` names its configuration
(``benchmark/configs/<config>.json``), whose ``family`` names the module
in ``benchmark/systems/`` that builds the port's sampler with the
benchmark's seeded weights and drives its ``pipeline.generate``.

The steps before the window (the cell's ``warmup_steps``: compilation,
the dense and ramp steps of the carve's warm-up) are set-up, each ended
by a synchronisation. The window starts when they end. Inside it the
host clock is read after each step without a synchronisation, as the
sampler loop runs for its users; once it reads ``--seconds`` past the
start, the device is synchronised and the window ends there, over every
step launched. A clip that ends inside the window is followed by the
next clip, whose set-up and warm-up steps count in the window.

``--trace 0`` reports the cell's end-to-end metrics: ``step_s``, the
window's seconds over its steps, and ``setup_s``, the seconds from this
file's first line to the window's start, kernel builds included in a run
that builds them (the line's ``setup_split`` gives their seconds apart,
``build_s``, with the other parts of set-up). ``--trace 1`` runs the window
under ``torch.profiler`` and reports the per-layer metrics that
``BENCHMARK.json`` lists for the cell, each read by
``benchmark/metrics/<name>.py`` from the trace, the program's counters
and the cell's shapes. K1 is priced by the tiles of the block lists each
launch was given, D by each launch's own shape as the probe observed it
(``benchmark/tracing.py``). In either mode a thread samples the card's SM
clock, power draw and clock-event reasons over the window
(``benchmark/clock.py``); the line's ``device`` gains ``sm_clock_mhz``,
``power_w`` and ``throttle`` from them.

Once the window has closed, the peak memory is read, the program is
freed and the plain reference (``benchmark/reference/``) checks a step of
the window drawn from the seed (and the clip's start): ``correct`` is
whether every number lies within its limit in the cell's file. The last
line of standard output is the result as JSON.

Adding a configuration takes new files and new entries alone; the
harness and its tests find each piece by name:

- ``benchmark/configs/<config>.json``: the sizes as run, the published
  source, ``reduced``, and ``family``, which names the system module;
- ``benchmark/workloads/<cell>.json``: the configuration, ``chips``, the
  sampler's options, ``warmup_steps`` and the limits of ``correct``;
- for a new family, ``benchmark/systems/<family>.py``: a ``Cell``
  (``CellBase``) that builds the port with the benchmark's weights and
  runs a clip (``run_clip``), gives ``facts()`` (the GEMM operations of
  a step), ``density()``, ``check()`` and ``controls`` (the precision
  controls it takes); its plain reference under ``benchmark/reference/``
  and its operation counts under ``benchmark/flops/``; and
  ``benchmark/tests/tiny/<family>.py``, the tiny CPU size of its cells
  and the faults the check tests plant (``tiny``, ``state_unchanged``,
  ``wrap_output``);
- ``BENCHMARK.json``: the ``configs`` and ``workloads`` entries, and the
  cell in the ``workloads`` lists of the per-layer metrics it reports (a
  new metric: ``benchmark/metrics/<name>.py``).

K1 and D need no fact: the probe prices what the window launched.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "jenga_tpu")


def _fixed_caches():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into ``jenga_tpu_torch/_build/``)."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ.setdefault(var, str(cache / sub))
    os.environ.setdefault("USE_FLAX", "0")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str):
    """(workload, config) of a cell, found by name."""
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    config = load_json(BENCH / "configs" / f"{workload['config']}.json")
    return workload, config


def layer_metrics(name: str) -> list:
    """The per-layer metric names that ``BENCHMARK.json`` lists for cell
    ``name``."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    return [m["name"] for m in manifest["per_layer"]
            if name in m.get("workloads", [name])]


def load_reader(metric: str):
    """(``read(ctx)``, ``UNIT``) of ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read, mod.UNIT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def gpu_power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


class _WindowClosed(Exception):
    pass


class _BuildClock:
    """The seconds of the program's kernel builds in this run: every
    ``nvcc`` process started between the clock's creation and ``stop``
    (the port compiles a kernel at first use when its library is not in
    the build cache)."""

    def __init__(self):
        self.seconds, self.builds = 0.0, 0
        self._run = subprocess.run
        subprocess.run = self._timed

    def _timed(self, cmd, *args, **kwargs):
        t = time.perf_counter()
        try:
            return self._run(cmd, *args, **kwargs)
        finally:
            if (isinstance(cmd, (list, tuple)) and cmd
                    and os.path.basename(str(cmd[0])) == "nvcc"):
                self.seconds += time.perf_counter() - t
                self.builds += 1

    def stop(self):
        subprocess.run = self._run


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             workload=None, config=None, control=None, metrics=None,
             breaker=None) -> dict:
    """Run cell ``name`` once on ``device`` and return its result. Tests
    pass ``workload`` / ``config`` dicts (a small model on the CPU),
    ``metrics`` (the per-layer names) and ``breaker(cell)``, which may
    break the timed path before the window."""
    import torch

    from benchmark import clock, tracing

    if workload is None:
        workload, config = load_cell(name)
    if metrics is None:
        metrics = layer_metrics(name) if trace else []
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    system = importlib.import_module(f"benchmark.systems.{config['family']}")
    marks = {"imports": time.perf_counter() - _T0}
    cell = system.Cell(config, workload, seed, device, control=control)
    sync()
    marks["weights"] = time.perf_counter() - _T0
    if breaker is not None:
        breaker(cell)
    warmup = cell.warmup_steps
    st = dict(start=None, end=None, steps=0, clip=0)
    probe = tracing.Probe(cuda) if trace else None
    clocks = clock.ClockSampler(clock.nvml_index(device)) if cuda else None

    def on_step(i):
        if st["start"] is None:
            sync()
            now = time.perf_counter()
            if i == 0:
                marks["first_step"] = now - _T0
            if probe is not None and i == warmup - 2:
                probe.arm()
            if i == warmup - 1:
                builds.stop()
                st["start"] = now
                cell.recording = True
                if cuda:
                    torch.cuda.reset_peak_memory_stats(device)
                if probe is not None:
                    probe.begin()
                if clocks is not None:
                    clocks.start()
            return
        st["steps"] += 1
        if time.perf_counter() - st["start"] >= seconds:
            sync()
            st["end"] = time.perf_counter()
            raise _WindowClosed

    if probe is not None and warmup == 1:
        probe.arm()
    builds = _BuildClock()
    try:
        while True:
            cell.run_clip(st["clip"], on_step)
            st["clip"] += 1
    except _WindowClosed:
        pass
    finally:
        builds.stop()
        if clocks is not None:
            clocks.stop()
        if probe is not None:
            probe.end()
    window_s = st["end"] - st["start"]
    setup_s = st["start"] - _T0
    # set-up by part: imports, weights and model, the first step (curve
    # plans, kernel builds, step 0), the other warm-up steps; and the
    # seconds of the kernel builds among them (0 where the build cache
    # held every kernel)
    split = {"imports_s": marks["imports"],
             "weights_s": marks["weights"] - marks["imports"],
             "first_step_s": marks["first_step"] - marks["weights"],
             "warmup_s": setup_s - marks["first_step"],
             "build_s": builds.seconds, "kernels_built": builds.builds}
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    result = {"attempted": st["steps"], "failed": 0,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if clocks is not None:
        result["device"].update(clocks.summary())
    if probe is not None:
        ctx = probe.context(cell, st["steps"], window_s)
        ctx["density"] = cell.density()
        result["metrics"] = {}
        for metric in metrics:
            read, unit = load_reader(metric)
            value = read(ctx)
            if value is not None:
                result["metrics"][metric] = {"value": value, "unit": unit}
        result["device"].update(busy_s=ctx["busy_s"], window_s=window_s)
        result["breakdown"] = ctx["breakdown"]
    else:
        result["metrics"] = {
            "step_s": {"value": window_s / st["steps"], "unit": "s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    cell.release()
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    numbers = cell.check()
    result["setup_split"] = split
    result["reference_s"] = time.perf_counter() - t_ref
    limits = workload["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    bad = [k for k, c in checks.items() if not c["value"] <= c["limit"]]
    result["failed"] = len({k.split("_")[0] for k in bad})
    result["correct"] = not bad and set(numbers) == set(limits)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    _fixed_caches()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8", "fp8ref"), default=None,
                    help="for setting the limits, never in a check: fp8, "
                         "HunyuanVideo's own fp8 weight path; fp8ref, the "
                         "reference computed in fp8 in the program's place")
    args = ap.parse_args(argv)
    workload, _ = load_cell(args.workload)
    import torch
    chips = int(workload.get("chips", 1))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"error: cell {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {have} (no CPU fallback)", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", control=args.control)
    result["device"]["power"] = gpu_power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"error: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["checks"] = checks       # last key of the line
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
