"""The card's SM clock, power draw and clock-event (throttle) reasons over
the measured window.

A thread of the benchmark's own process samples the card about every
0.25 s, from the window's start to its end: through NVML (``pynvml``)
where it is installed, else from one ``nvidia-smi`` process that prints
a sample of that card every 250 ms. Both only read; nothing on the card
is set, and no CUDA call is made, so the window gets no synchronisation
from it. The run's line carries the means and the reasons seen
(``summary``): readings beside the metrics, not metrics.
"""

from __future__ import annotations

import subprocess
import sys
import threading

PERIOD_S = 0.25
# NVML's clocks-event reason bits (nvml.h, nvmlClocksEventReason*)
REASONS = {0x1: "gpu_idle", 0x2: "applications_clocks_setting",
           0x4: "sw_power_cap", 0x8: "hw_slowdown", 0x10: "sync_boost",
           0x20: "sw_thermal_slowdown", 0x40: "hw_thermal_slowdown",
           0x80: "hw_power_brake_slowdown", 0x100: "display_clock_setting"}
QUERY = "clocks.sm,power.draw,clocks_event_reasons.active"


def reason_names(mask: int) -> list:
    """The names of the reason bits set in ``mask`` (unknown bits by
    their hex value)."""
    names = [name for bit, name in REASONS.items() if mask & bit]
    rest = mask & ~sum(REASONS)
    return names + ([hex(rest)] if rest else [])


def nvml_index(device) -> int:
    """NVML's index of torch CUDA device ``device`` (NVML ignores
    ``CUDA_VISIBLE_DEVICES``)."""
    import torch
    find = getattr(torch.cuda, "_get_nvml_device_index", None)
    return find(device) if find is not None else device.index or 0


def _nvml_reader(index: int):
    """(a function giving (SM MHz, W, reason mask), NVML's shutdown), or
    None without ``pynvml`` or NVML."""
    try:
        import pynvml
    except ImportError:
        return None
    try:
        pynvml.nvmlInit()
        handle = pynvml.nvmlDeviceGetHandleByIndex(index)
    except pynvml.NVMLError as e:
        print(f"clock: NVML unusable ({e}); nvidia-smi instead",
              file=sys.stderr)
        return None
    reasons = getattr(pynvml, "nvmlDeviceGetCurrentClocksEventReasons",
                      None) or pynvml.nvmlDeviceGetCurrentClocksThrottleReasons

    def read():
        return (pynvml.nvmlDeviceGetClockInfo(handle, pynvml.NVML_CLOCK_SM),
                pynvml.nvmlDeviceGetPowerUsage(handle) / 1e3, reasons(handle))
    return read, pynvml.nvmlShutdown


def parse_smi(line: str):
    """(SM MHz, W, reason mask) of one ``nvidia-smi`` line of ``QUERY``
    in ``csv,noheader,nounits``; None for a line it cannot read."""
    try:
        mhz, watts, mask = (f.strip() for f in line.split(","))
        return float(mhz), float(watts), int(mask, 16)
    except ValueError:
        return None


class ClockSampler:
    """Samples one card from ``start`` to ``stop``."""

    def __init__(self, index: int):
        self.index = index
        self.samples = []       # (SM MHz, W, reason mask)
        self._read, self._close = _nvml_reader(index) or (None, None)
        self._halt = threading.Event()
        self._thread = self._proc = None

    def start(self):
        if self._read is not None:
            target = self._poll
        else:
            try:
                self._proc = subprocess.Popen(
                    ["nvidia-smi", f"--query-gpu={QUERY}",
                     "--format=csv,noheader,nounits", "-i", str(self.index),
                     "-lms", str(int(PERIOD_S * 1000))],
                    stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                    text=True)
            except OSError as e:
                print(f"clock: no NVML and no nvidia-smi ({e}); the window "
                      "is not sampled", file=sys.stderr)
                return
            target = self._lines
        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()

    def _poll(self):
        while True:
            try:
                self.samples.append(self._read())
            except Exception as e:  # noqa: BLE001  (the thread's boundary)
                print(f"clock: sampling stopped: {e!r}", file=sys.stderr)
                return
            if self._halt.wait(PERIOD_S):
                return

    def _lines(self):
        for line in self._proc.stdout:
            sample = parse_smi(line)
            if sample is not None and not self._halt.is_set():
                self.samples.append(sample)

    def stop(self):
        """End the sampling and wait for its thread and process
        (idempotent)."""
        self._halt.set()
        if self._proc is not None:
            self._proc.terminate()
            self._proc.wait(timeout=30)
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._close is not None:
            self._close()
            self._close = None

    def summary(self) -> dict:
        """``sm_clock_mhz`` and ``power_w`` (means of the samples),
        ``throttle`` (each reason seen: its share of the samples) and
        ``clock_samples``; {} where nothing was sampled."""
        n = len(self.samples)
        if not n:
            return {}
        seen = {}
        for _, _, mask in self.samples:
            for name in reason_names(mask):
                seen[name] = seen.get(name, 0) + 1
        return {"sm_clock_mhz": sum(s[0] for s in self.samples) / n,
                "power_w": sum(s[1] for s in self.samples) / n,
                "throttle": {k: v / n for k, v in sorted(seen.items())},
                "clock_samples": n}

