"""The trace reduction on a made-up trace: device time is the union of
kernel intervals (annotations left out), per call and over the window;
idle gaps are labelled by the span open at the time; and the readers
under metrics/ take their numbers from it."""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from vbnbench import registry
from vbnbench.trace import CALL, VBN, reduce_trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def ev(name, a, b, dev=CPU):
    return SimpleNamespace(
        name=name, device_type=dev, is_user_annotation=False,
        time_range=SimpleNamespace(start=a, end=b, elapsed_us=lambda: b - a))


def fake_prof():
    events = [
        ev(CALL, 0, 100), ev(VBN, 15, 100), ev(CALL, 100, 200), ev(VBN, 120, 200),
        ev("k1", 20, 60, CUDA), ev("k2", 50, 90, CUDA),  # union 20-90
        ev("k1", 130, 170, CUDA),
        ev(VBN, 15, 100, CUDA),  # the span's annotation on the device row
    ]
    return SimpleNamespace(events=lambda: events)


def test_reduce_trace():
    t = reduce_trace(fake_prof())
    assert [c["busy_us"] for c in t["calls"]] == [70, 40]
    assert [c["events"] for c in t["calls"]] == [2, 1]
    assert t["window_us"] == 200 and t["busy_us"] == 110
    assert t["device_ops"][0] == ("k1", 80e-6)
    labels = dict((round(v * 1e6), k) for k, v in t["idle_gaps"])
    assert labels[20] == "in the client, between VBN calls"  # 0-20
    assert labels[40] == "in the client, between VBN calls"  # 90-130, mid 110
    assert labels[30] == "inside the VBN call"  # 170-200


def test_readers_on_the_trace():
    t = reduce_trace(fake_prof())
    t["least_ms"] = [0.007, 0.004]
    t["peak_bytes"] = 2**31
    read = {m["name"]: registry.metric_reader(m["name"]).read(t)
            for m in registry.load_benchmark()["per_layer"]}
    assert read["host_ms_per_call"] == pytest.approx((30 + 60) / 2 / 1e3)
    assert read["kernels_per_call"] == 1.5
    assert read["lw_roofline_pct"] == pytest.approx(100 * 0.011 / 0.110)
    assert read["device_idle_pct"] == pytest.approx(45.0)
    assert read["device_peak_gib"] == 2.0
    assert registry.metric_reader("lw_roofline_pct").read({"calls": []}) is None


@pytest.mark.cuda
def test_one_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run(
        [sys.executable, "-m", "vbnbench.run", "--workload", "alarm-lw.mixed256",
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
