"""The window's clock readings (``benchmark/clock.py``): the reasons
decoded from NVML's bits, the ``nvidia-smi`` lines read, and a sampler
that keeps what it read between ``start`` and ``stop``, through NVML or
through an ``nvidia-smi`` process that it ends and waits for."""

import os
import time

import pytest

import _tiny  # noqa: F401  (puts the checkout on sys.path)
from benchmark import clock


def test_reason_bits_are_named():
    assert clock.reason_names(0x0) == []
    assert clock.reason_names(0x4) == ["sw_power_cap"]
    assert clock.reason_names(0x1 | 0x4 | 0x40) == [
        "gpu_idle", "sw_power_cap", "hw_thermal_slowdown"]
    assert clock.reason_names(0x4 | 0x1000) == ["sw_power_cap", "0x1000"]


def test_smi_lines_are_read():
    assert clock.parse_smi("1665, 690.12, 0x0000000000000004\n") == (
        1665.0, 690.12, 4)
    assert clock.parse_smi("[N/A], 690.12, 0x4") is None
    assert clock.parse_smi("") is None


def _samples(sampler, seconds=0.6):
    sampler.start()
    time.sleep(seconds)
    sampler.stop()
    return sampler.summary()


def test_the_nvml_sampler_means_and_reason_shares(monkeypatch):
    reads = iter([(1600, 690.0, 0x4), (1700, 700.0, 0x4 | 0x1)]
                 + [(1650, 695.0, 0x0)] * 100)
    closed = []
    monkeypatch.setattr(clock, "_nvml_reader",
                        lambda index: (lambda: next(reads),
                                       lambda: closed.append(index)))
    sampler = clock.ClockSampler(3)
    got = _samples(sampler)
    n = got["clock_samples"]
    assert n >= 2 and n == len(sampler.samples)
    mhz = [s[0] for s in sampler.samples]
    assert got["sm_clock_mhz"] == pytest.approx(sum(mhz) / n)
    assert got["throttle"]["sw_power_cap"] == pytest.approx(2 / n)
    assert got["throttle"]["gpu_idle"] == pytest.approx(1 / n)
    assert closed == [3] and not sampler._thread.is_alive()
    # stop is idempotent; nothing is sampled after it
    sampler.stop()
    time.sleep(0.3)
    assert len(sampler.samples) == n and closed == [3]


def test_without_nvml_an_smi_process_is_read_and_ended(monkeypatch,
                                                       tmp_path):
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho \"$@\" > \"$0.args\"\n"
                   "while true; do echo '1700, 688.5, 0x0000000000000004';"
                   " sleep 0.05; done\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(clock, "_nvml_reader", lambda index: None)
    sampler = clock.ClockSampler(2)
    got = _samples(sampler)
    assert got["clock_samples"] >= 2
    assert got["sm_clock_mhz"] == 1700.0 and got["power_w"] == 688.5
    assert got["throttle"] == {"sw_power_cap": 1.0}
    assert sampler._proc.returncode is not None
    assert not sampler._thread.is_alive()
    args = (tmp_path / "nvidia-smi.args").read_text().split()
    assert args[args.index("-i") + 1] == "2" and "-lms" in args


def test_nothing_sampled_gives_no_keys(monkeypatch):
    monkeypatch.setattr(clock, "_nvml_reader", lambda index: None)
    monkeypatch.setenv("PATH", "")
    sampler = clock.ClockSampler(0)
    sampler.start()
    sampler.stop()
    assert sampler.summary() == {}
