"""Tiny CPU runs of each kind of cell, sound and broken.

Each run skips the harness's look for a card and drives the rest of a run
(`skybench.run.measure` with device="cpu": set-up, the window, the check
against the plain reference) at the conftest's tiny sizes, on the
program's plain versions. A sound run comes out correct; a run with its
timed path broken underneath comes out not correct, once for each fault
a cell of that kind can have (`skybench.control`'s `Unchanged`,
`HalfMean` and `Altered`). The exchange between chips does not exist in
these one-card cells. The control, the plain reference computed in
bfloat16 in the program's place, comes out not correct too.

At coverage 0.7, on three seeds, sound serving runs read map SNR
15.0-15.9 dB and frame SNR 22.2-26.6 dB; the faults at most 4.4 (maps:
Unchanged, HalfMean) or 13.4 (frames: Altered); the bfloat16 reference
0.0 and at most 6.2. Sound cycles read map SNR 12.8 dB, the faults at
most 3.2 and the bfloat16 reference 0.0. The tiny limits (conftest) are
8 dB (maps) and 18 dB (frames).

The tiny scene-cut cell (a cut at every cycle boundary, `at_frame` 0,
which the program renders whole) adds `control.CUT_FAULTS`' `StaleCut`.
On ten seeds its sound runs read map SNR 10.7-17.7 dB and frame SNR
8.3-23.4 dB (a new sun every cut; the low frames are the tiny march's
map error where the camera looks: the reference's composite of the
program's own maps reads the program's frame to 88 dB); `StaleCut`
1.3-1.6 dB on maps; the bfloat16 reference 0.0 on maps and -8.4 to 5.5
on frames. Its tiny limits are 8 dB (maps) and 4 dB (frames).
"""

import pytest

from skybench import control, run
from skybench.tests.conftest import TINY_CUT_CELL

SERVE = "serve-768-f64.broken-0.35"
CYCLE = "serve-768-f64.cycle-0.35"
SEED = 3_000_000_123


def _line(root, workload, hooks=None):
    return run.measure(workload, SEED, 0.5, False, device="cpu", root=root, hooks=hooks)


@pytest.mark.parametrize("workload", [SERVE, CYCLE])
def test_sound_run_is_correct(tiny_root, workload):
    line = _line(tiny_root, workload)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("workload", [SERVE, CYCLE])
def test_broken_run_is_not_correct(tiny_root, workload, fault):
    line = _line(tiny_root, workload, control.FAULTS[fault]())
    assert not line["correct"], line["checks"]
    assert line["failed"] >= 1


@pytest.mark.parametrize("workload", [SERVE, CYCLE])
def test_control_is_not_correct(tiny_root, workload):
    r = run.resolve(run.load_benchmark(tiny_root), workload, tiny_root)
    limits = r["config"]["limits"]
    rows = control.control_readings(workload, [SEED], device="cpu", root=tiny_root)
    assert any(v < limits[k] for k, v in rows[0]["checks"].items()), rows


def test_sound_cut_run_is_correct_and_labels_its_cuts(tiny_cut_root):
    """The tiny scene-cut cell (a cut at every cycle boundary), traced on
    the CPU: correct, and the window's cut ticks labelled `cut` for the
    cell's reader (a 3-s window holds one at least)."""
    line = run.measure(TINY_CUT_CELL, SEED, 3.0, True, device="cpu", root=tiny_cut_root)
    assert line["correct"], line["checks"]
    assert line["metrics"]["cut_tick_ms.serve"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(control.CUT_FAULTS))
def test_broken_cut_run_is_not_correct(tiny_cut_root, fault):
    line = _line(tiny_cut_root, TINY_CUT_CELL, control.CUT_FAULTS[fault]())
    assert not line["correct"], line["checks"]
    assert line["failed"] >= 1


def test_cut_control_is_not_correct(tiny_cut_root):
    r = run.resolve(run.load_benchmark(tiny_cut_root), TINY_CUT_CELL, tiny_cut_root)
    limits = r["config"]["limits"]
    rows = control.control_readings(TINY_CUT_CELL, [SEED], device="cpu", root=tiny_cut_root)
    assert any(v < limits[k] for k, v in rows[0]["checks"].items()), rows
