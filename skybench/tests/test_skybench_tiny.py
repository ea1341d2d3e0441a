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
"""

import pytest

from skybench import control, run

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
