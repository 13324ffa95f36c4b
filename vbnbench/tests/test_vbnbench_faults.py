"""A run driven on the CPU, past the check for a CUDA device, at small sizes:
sound, it comes out correct; with the timed path broken underneath (an
answer altered where it is produced; half of each call's rows left out)
it comes out not correct; and the control, plain likelihood weighting at
a 64th of the particles in the program's place, fails the limits. The
check's numbers are in units of the Monte-Carlo error, so the limits hold
at these sizes as at the cell's."""

import numpy as np
import pytest

from vbnbench import check, registry, run

BENCH = registry.load_benchmark()
SMALL = {
    "alarm-lw.fixed512": {"n_samples": 4096, "rows_per_call": 16, "sample_rows": 64},
    "alarm-lw.mixed256": {"n_samples": 4096, "rows_per_call": 16, "sample_rows": 64},
    "gauss8-kde-lw.mixed96": {"n_samples": 2048, "rows_per_call": 8, "sample_rows": 16},
}
SEED = 2**31 + 12345


def _run(cell, **kw):
    return run.run_cell(cell, SEED, 1.0, False, device="cpu",
                        overrides=SMALL[cell], bench=BENCH, **kw)


def altered(serve):
    def broken(call):
        rows = np.array(serve(call), copy=True)
        if rows.shape[1] == 2:  # moments: the mean moved by ten stds
            rows[0, 0] += 10.0 * max(rows[0, 1], 1e-3)
        else:  # pmf: all mass on one class
            rows[0] = 0.0
            rows[0, 0 if rows[0].argmax() else 1] = 1.0
        return rows
    return broken


def half_left_out(serve):
    def broken(call):
        rows = serve(call)
        return rows[: len(rows) // 2]
    return broken


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["line"]["correct"], res["judged"]
    assert res["line"]["failed"] == 0
    assert list(res["line"])[-1] == "checks"


@pytest.mark.parametrize("fault", [altered, half_left_out],
                         ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("cell", list(SMALL))
def test_broken_path_is_not_correct(cell, fault):
    res = _run(cell, wrap_serve=fault)
    assert not res["line"]["correct"], res["judged"]


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_the_limits(cell):
    res = _run(cell, control=True)
    assert res["line"]["correct"]
    lim = registry.limits(cell)
    ctl = res["judged"]["control"]
    assert not check.verdict(ctl, {k: v for k, v in lim.items() if k in ctl}), ctl
