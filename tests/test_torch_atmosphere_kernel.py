"""The atmosphere LUTs' kernels K10–K11 (`ops/atmosphere_kernel.py`,
`csrc/atmosphere.cu`) on the CPU, where their wrappers take the plain
versions, and the prebake schedule the card's costs give the engine.

- The public `transmittance_lut`, `sky_lut` and `sky_lut_rows` against JAX's
  at tests/test_torch_brick_atmo.py's gates (80 dB, 60 dB): both suns,
  bands of the serving point's schedule, 25 and 100 rows.
- The wrappers: a CPU tensor takes the plain version (bitwise, no launch
  counted), any device but the CPU and CUDA raises ValueError.
- `_derive_prebake_schedule` at the serving point (`PerfConfig(768, 64,
  128)`, cone (32, 512, 512), tile cull) fits its 64 ticks, predicts no
  sliced stage's tick above the budget it settled on, and puts the sky LUT
  in the bands its costs imply; a stage whose call costs more than the
  budget is not split into ticks that each pay it.
- `python -m cloudscape_tpu_torch.probe_prebake`'s `run` at a tiny size.
- `stage_of` (the engine's `_prebake_stage`) over one cycle, at 16
  frames and at 4, where a tick takes several steps, and
  chip_smoke.py's instruction and MUFU counts of K10–K11 on a SASS listing.
- The kernels' launch geometry (`launch_geometry`, `thread_work`): every
  texel of every band the schedule can pick, and of K11's LUT, taken by one
  group whose lanes take each step once; the lanes a texel as the source
  sets them; chip_smoke's bound from the frozen work a texel.

The kernels themselves run only on a card: chip_smoke.py holds them against
these plain versions there (phase 4c).
"""

import collections
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke

from cloudscape_tpu.models import atmosphere as jatmo
from cloudscape_tpu.utils.image import psnr
from cloudscape_tpu_torch import PerfConfig, probe_prebake
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models import atmosphere as tatmo
from cloudscape_tpu_torch.models.packs import procedural_noise_pack
from cloudscape_tpu_torch.ops import atmosphere_kernel

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

SUNS = [(0.3, 0.5, -0.8), (0.0, -0.05, 1.0)]


def _unit(sun):
    s = np.asarray(sun, np.float32)
    return s / np.linalg.norm(s)


def schedule_engine(**perf):
    """An engine at the serving point's shapes with only what
    `_derive_prebake_schedule` reads (no textures, no kernels)."""
    eng = CloudSkyEngine.__new__(CloudSkyEngine)
    eng.cone_res = (32, 512, 512)
    eng.perf = PerfConfig(**(perf or dict(texture_size=768, frames_to_update=64,
                                          march_steps=128)))
    eng.tile_cull = True
    eng.device = torch.device("cpu")
    eng._derive_prebake_schedule()
    return eng


@pytest.fixture(scope="module")
def jax_tlut():
    return np.array(jatmo.transmittance_lut())


def test_transmittance_lut_matches_jax(jax_tlut):
    """The public function on the CPU: JAX's LUT at ≥ 80 dB, and the plain
    version's bits."""
    got = tatmo.transmittance_lut(device="cpu")
    assert got.shape == (64, 256, 4) and got.dtype == torch.float32
    assert psnr(got.numpy(), jax_tlut) >= 80.0
    assert torch.equal(got, tatmo._transmittance_lut_plain(device="cpu"))


@pytest.mark.parametrize("rows", ["schedule", 25, 100])
@pytest.mark.parametrize("sun", SUNS)
def test_sky_lut_bands_match_jax(jax_tlut, sun, rows):
    """Bands of `rows` rows (the serving schedule's, 25, 100) through the
    public `sky_lut_rows`, stacked, against JAX's whole `sky_lut` at ≥ 60
    dB, and each band the plain version's bits."""
    if rows == "schedule":
        rows = schedule_engine()._sky_rows
    s = _unit(sun)
    tt = torch.from_numpy(jax_tlut)
    want = np.asarray(jatmo.sky_lut(jnp.asarray(jax_tlut), jnp.asarray(s)))
    bands = []
    for r0 in range(0, 100, rows):
        band = tatmo.sky_lut_rows(tt, torch.from_numpy(s), r0, rows=rows)
        assert torch.equal(band, tatmo._sky_lut_rows_plain(
            tt, torch.from_numpy(s), r0, rows=rows))
        bands.append(band)
    got = torch.cat(bands).numpy()
    assert got.shape == want.shape == (100, 200, 4)
    assert np.isfinite(got).all()
    assert psnr(got, want) >= 60.0
    if rows == 100:
        np.testing.assert_array_equal(tatmo.sky_lut(tt, torch.from_numpy(s)).numpy(), got)


def test_wrappers_take_the_plain_version_on_the_cpu():
    """CPU tensors and devices: the plain versions' bits, no launch counted,
    a sun given as a tuple or a tensor alike."""
    before = dict(atmosphere_kernel.launches)
    t = atmosphere_kernel.transmittance_lut(32, 8, "cpu")
    assert torch.equal(t, tatmo._transmittance_lut_plain(32, 8, device="cpu"))
    sky = atmosphere_kernel.sky_lut_rows(t, (0.3, 0.5, -0.8), 3, 4, 16, 10)
    assert sky.shape == (4, 16, 4)
    assert torch.equal(sky, tatmo._sky_lut_rows_plain(
        t, torch.tensor([0.3, 0.5, -0.8]), 3, rows=4, width=16, height=10))
    assert atmosphere_kernel.launches == before


@pytest.mark.parametrize("what", ["transmittance", "sky"])
def test_wrappers_reject_other_devices(what):
    """A `meta` tensor or device is neither the CPU nor a card: ValueError."""
    with pytest.raises(ValueError, match="unsupported device"):
        if what == "transmittance":
            tatmo.transmittance_lut(16, 4, device="meta")
        else:
            tatmo.sky_lut(torch.zeros((4, 16, 4), device="meta"), (0.0, 1.0, 0.0))


def test_serving_schedule_fits_its_budget():
    """At the serving point: the stages fit the cycle's 64 ticks with no
    assembly ticks; each sliced stage's predicted tick (its call plus its
    slice at the unit cost) is within the budget the schedule settled on,
    which is at least `_BAKE_TICK_MS`; the sky LUT is the bands its costs
    imply (the largest divisor of 100 rows within the budget)."""
    eng = schedule_engine()
    c, budget = eng._BAKE_COSTS, eng._bake_budget_ms
    stages = {"occ": (eng._occ_slice, eng._n_occ, 32 * 512 * 512),
              "cone": (eng._cone_slice, eng._n_cone_slices, eng._cone_capacity),
              "sky": (eng._sky_rows, eng._n_sky, 100),
              "cull": (eng._cull_slice, eng._n_cull, eng._n_sub)}
    total = 4 + 2 + sum(n for _, n, _ in stages.values())
    assert total == eng._bake_ticks <= 64
    assert budget >= eng._BAKE_TICK_MS
    for st, (k, n, units) in stages.items():
        call_ms, unit_ms = c[st]
        assert n == -(-units // k), st
        assert call_ms + k * unit_ms <= budget or k == 1, (st, call_ms + k * unit_ms, budget)
    fit_rows = min(max(int((budget - c["sky"][0]) / c["sky"][1]), 1), 100)
    assert eng._sky_rows == max(r for r in range(1, fit_rows + 1) if 100 % r == 0)
    assert eng._n_sky == 100 // eng._sky_rows


def test_schedule_pays_a_stage_call_once_a_tick():
    """A stage whose call alone is over the starting budget is not cut into
    one-unit ticks that each pay it: the budget grows until the cycle fits,
    and the stage's slices take the budget less its call."""
    eng = schedule_engine()
    eng._BAKE_COSTS = dict(eng._BAKE_COSTS, sky=(3 * eng._BAKE_TICK_MS, 1e-3))
    eng._derive_prebake_schedule()
    assert eng._bake_budget_ms > 3 * eng._BAKE_TICK_MS
    assert eng._n_sky == 1 and eng._sky_rows == 100
    assert 4 + 2 + eng._n_occ + eng._n_cone_slices + eng._n_sky + eng._n_cull <= 64


@pytest.mark.parametrize("tile_cull", [True, False])
def test_prebake_stage_names_each_step(tile_cull):
    """`stage_of` (the engine's `_prebake_stage`) over one cycle at a tiny
    size, each sliced stage cut into two or more ticks: the boundary, then
    each stage for as many ticks as the schedule gives it, in
    `_advance_prebake`'s order, then steady ticks; the next boundary
    takes the baked cone cache and sky LUT."""
    from cloudscape_tpu_torch import CloudConfig, SunState

    noise = procedural_noise_pack(0, 16, 16, 64, device="cpu")
    eng = CloudSkyEngine(perf=PerfConfig(texture_size=64, frames_to_update=16,
                                         march_steps=16),
                         config=CloudConfig(cloud_coverage=0.35),
                         sun=SunState(direction=(0.3, 0.25, -0.9)), noise=noise,
                         kernel="fast3", cone_res=(4, 32, 32), tile_cull=tile_cull,
                         device="cpu")
    units = {"occ": 4 * 32 * 32, "cone": eng._cone_capacity, "sky": 100,
             "cull": max(eng._n_sub, 1)}
    eng._BAKE_COSTS = {st: (0.0, 2.0 / u) for st, u in units.items()}
    eng._BAKE_TICK_MS = 1.0
    eng._derive_prebake_schedule()
    assert min(eng._n_occ, eng._n_cone_slices, eng._n_sky) >= 2
    assert eng._n_cull >= 2 or not tile_cull
    now = 0.0
    eng.update_sky(now)  # the warm start
    while probe_prebake.stage_of(eng) != "boundary":
        now += 1 / 60
        eng.update_sky(now)
    stages = []
    for _ in range(eng.perf.frames_to_update):
        stages.append(probe_prebake.stage_of(eng))
        now += 1 / 60
        eng.update_sky(now)
    want = (["boundary"] + ["occupancy"] * eng._n_occ + ["finalize"]
            + ["cone"] * eng._n_cone_slices + ["wrap"] + ["sky_band"] * eng._n_sky
            + (["cull"] * eng._n_cull + ["cull_finalize", "cull_read"]
               if tile_cull else []))
    assert stages == want + ["steady"] * (len(stages) - len(want))
    pend = eng._pending
    assert probe_prebake.stage_of(eng) == "boundary"
    eng.update_sky(now + 1 / 60)
    assert eng._cone_cache is pend.cone
    assert any(torch.equal(img, pend.sky) for img in eng.sky_ring)
    assert not tile_cull or eng._tile_buckets is pend.buckets


# The f4 case's ticks after its boundary: every stage costs 2 ms whole
# (the test's costs), so the three ticks after the boundary can take no
# less than two stages each with tile cull, one each without.
F4_TICKS = {True: ["occupancy+finalize+cone+wrap", "sky_band+cull+cull_finalize+cull_read",
                   "steady"],
            False: ["occupancy+finalize", "cone+wrap", "sky_band"]}


@pytest.mark.parametrize("tile_cull", [True, False])
def test_prebake_stage_names_each_step_of_a_short_cycle(tile_cull):
    """`stage_of` over an f4 cycle at the same tiny size and costs: the
    steps cannot have a tick each, so each stage is one step and a tick
    that takes several names them in order (F4_TICKS), the bake done before
    the next boundary, which takes the baked cone cache, sky LUT and
    buckets."""
    from cloudscape_tpu_torch import CloudConfig, SunState

    noise = procedural_noise_pack(0, 16, 16, 64, device="cpu")
    eng = CloudSkyEngine(perf=PerfConfig(texture_size=64, frames_to_update=4,
                                         march_steps=16),
                         config=CloudConfig(cloud_coverage=0.35),
                         sun=SunState(direction=(0.3, 0.25, -0.9)), noise=noise,
                         kernel="fast3", cone_res=(4, 32, 32), tile_cull=tile_cull,
                         device="cpu")
    units = {"occ": 4 * 32 * 32, "cone": eng._cone_capacity, "sky": 100,
             "cull": max(eng._n_sub, 1)}
    eng._BAKE_COSTS = {st: (0.0, 2.0 / u) for st, u in units.items()}
    eng._BAKE_TICK_MS = 1.0
    eng._derive_prebake_schedule()
    assert max(eng._n_occ, eng._n_cone_slices, eng._n_sky, eng._n_cull) == 1
    now = 0.0
    eng.update_sky(now)  # the warm start
    while probe_prebake.stage_of(eng) != "boundary":
        now += 1 / 60
        eng.update_sky(now)
    stages = []
    for _ in range(4):
        stages.append(probe_prebake.stage_of(eng))
        now += 1 / 60
        eng.update_sky(now)
    assert stages == ["boundary"] + F4_TICKS[tile_cull]
    pend = eng._pending
    assert probe_prebake.stage_of(eng) == "boundary"
    eng.update_sky(now + 1 / 60)
    assert eng._cone_cache is pend.cone
    assert any(torch.equal(img, pend.sky) for img in eng.sky_ring)
    assert not tile_cull or eng._tile_buckets is pend.buckets


SASS = """
\t\tFunction : _ZN12_GLOBAL__N_110sky_kernelEPK6float4
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   S2R R0, SR_TID.X ;          /* 0x0000000000007919 */
        /*0010*/               @P0 EXIT ;                      /* 0x000000000000094d */
        /*0020*/                   MOV R1, RZ ;
        /*0030*/                   FADD R2, R2, R3 ;
        /*0040*/               @P1 BRA 0x70 ;
        /*0050*/                   CALL.REL.NOINC 0xd0 ;
        /*0060*/                   BRA 0x70 ;
        /*0070*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0080*/                   ISETP.NE.AND P2, PT, R1, 0x1e, PT ;
        /*0090*/               @P2 BRA 0x30 ;
        /*00a0*/                   STG.E [R4.64], R2 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   BRA 0xc0;
        /*00d0*/                   FMUL R2, R2, R2 ;
        /*00e0*/                   RET.REL.NODEC R14 0x0 ;
"""


def test_least_instructions_counts_the_short_path():
    """chip_smoke.py's count of K10–K11's work a texel on the one-thread
    form's SASS: the entry to the step loop (3), the loop body the short
    way past its slow-path CALL (5) once a step, then on to the EXIT (2); a
    loop that does not run one step a trip is refused."""
    (name, ins), = chip_smoke.sass_functions(SASS).items()
    assert "sky_kernel" in name and len(ins) == 15
    got = chip_smoke.least_instructions(ins, 30)
    assert got == dict(per_texel=3 + 30 * 5 + 2, pre=3, body=5, post=2, static=15)
    with pytest.raises(RuntimeError, match="one of 40 steps"):
        chip_smoke.least_instructions(ins, 40)


def test_fit_recovers_a_line():
    """The probe's fit: a call and a unit cost from a line, a flat stage
    its call alone."""
    call, unit = probe_prebake.fit([1, 2, 4], [3.0, 5.0, 9.0])
    assert call == pytest.approx(1.0) and unit == pytest.approx(2.0)
    call, unit = probe_prebake.fit([5, 25, 100], [0.02, 0.02, 0.02])
    assert call == pytest.approx(0.02, abs=1e-6) and unit == 1e-9


def test_probe_prebake_runs_on_the_cpu():
    """The probe's run at a tiny size: every stage timed at its sizes and
    fitted, the labelled ticks cross a boundary and run each stage, the
    sky-band ticks launch no kernel on the CPU, and the fitted schedule
    fits the cycle."""
    noise = procedural_noise_pack(0, 16, 16, 64, device="cpu")
    lines = []
    rec = probe_prebake.run("cpu", texture_size=64, frames=16, tile_steps=16,
                            cone_res=(4, 32, 32), view=(32, 18), ticks=20,
                            noise=noise, log=lines.append)
    assert rec["device"] == "cpu" and all(line.endswith("(cpu)") for line in lines)
    for st in ("occ", "cone", "sky", "cull"):
        assert len(rec["stages"][st]["sizes"]) == len(rec["stages"][st]["ms"]) == 3
        call_ms, unit_ms = rec["bake_costs"][st]
        assert call_ms >= 0.0 and unit_ms > 0.0
    for st in ("occ_finalize", "cull_finalize"):
        assert rec["stages"][st]["ms"] >= rec["stages"][st]["enqueue_ms"] > 0
    stages = [r["stage"] for r in rec["ticks"]]
    assert len(stages) == 20 and "boundary" in stages
    assert {"occupancy", "finalize", "cone", "wrap", "sky_band", "cull",
            "cull_finalize", "cull_read", "steady"} <= set(stages)
    assert all(r["sky_launches"] == 0 and r["arm"] in ("skip", "v3", "dense")
               for r in rec["ticks"])
    assert rec["bake_tick_ms"] == pytest.approx(0.4 * rec["steady_median_ms"])
    assert rec["schedule_fitted"]["ticks"] <= 16


MUFU_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_120transmittance_kernelEii
        /*0000*/                   MUFU.RSQ R5, R4 ;
        /*0010*/                   MOV R1, RZ ;
        /*0020*/               @P1 BRA 0x70 ;
        /*0030*/                   FMUL R2, R2, R2 ;
        /*0040*/                   FADD R2, R2, R3 ;
        /*0050*/                   FMUL R2, R2, R3 ;
        /*0060*/                   BRA 0x80 ;
        /*0070*/                   MUFU.EX2 R2, R2 ;
        /*0080*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0090*/                   ISETP.NE.AND P2, PT, R1, 0x28, PT ;
        /*00a0*/               @P2 BRA 0x20 ;
        /*00b0*/                   MUFU.EX2 R2, R2 ;
        /*00c0*/                   STG.E [R4.64], R2 ;
        /*00d0*/                   EXIT ;
"""


def test_least_mufu_takes_the_path_of_fewest_mufu():
    """The SFU term's count: the fewest MUFU a thread executes, on the path
    with the fewest of them (the loop's longer FMUL arm, no MUFU), which
    is not the path of the fewest instructions (the MUFU.EX2 arm): one
    before the loop, none a step, one after it."""
    (_, ins), = chip_smoke.sass_functions(MUFU_SASS).items()
    got = chip_smoke.least_mufu(ins, 40)
    assert got == dict(per_texel=2, pre=1, body=0, post=1, static=14)
    shortest = chip_smoke.least_instructions(ins, 40)
    assert shortest == dict(per_texel=2 + 40 * 5 + 3, pre=2, body=5, post=3, static=14)


def _geometry_cases():
    return ([("sky", rows * 200, rows) for rows in chip_smoke.SKY_BANDS]
            + [("transmittance", 64 * 256, None)])


@pytest.mark.parametrize("kernel,texels,rows", _geometry_cases())
def test_launch_geometry_takes_every_texel_and_step_once(kernel, texels, rows):
    """K10 on a band of every height the schedule can pick (200 texels a
    row) and K11 on its 64 x 256 LUT: the launch's threads, as the kernel
    deals them out, take every texel in one group of LANES lanes of one
    block, and the group's lanes every step of its march exactly once; no
    block is spare."""
    lanes = atmosphere_kernel.LANES[kernel]
    steps = atmosphere_kernel.STEPS[kernel]
    geometry = atmosphere_kernel.launch_geometry(texels, lanes)
    blocks, per_block, got_lanes = geometry
    assert got_lanes == lanes and per_block * lanes == atmosphere_kernel.THREADS
    assert (blocks - 1) * per_block < texels <= blocks * per_block
    taken = collections.Counter()
    groups = collections.defaultdict(list)
    for block in range(blocks):
        for thread in range(atmosphere_kernel.THREADS):
            work = atmosphere_kernel.thread_work(geometry, texels, steps, block, thread)
            if work is None:
                continue
            texel, its_steps = work
            groups[texel].append(block)
            taken.update((texel, s) for s in its_steps)
    assert sorted(groups) == list(range(texels))
    assert all(g == [g[0]] * lanes for g in groups.values())
    assert taken == collections.Counter({(t, s): 1 for t in range(texels)
                                         for s in range(steps)})


def test_lanes_are_the_kernel_sources():
    """THREADS, LANES and STEPS are csrc/atmosphere.cu's kThreads,
    kSkyLanes / kTransmittanceLanes and the marches' steps."""
    path = os.path.join(os.path.dirname(atmosphere_kernel.__file__), "..", "csrc",
                        "atmosphere.cu")
    with open(path) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert atmosphere_kernel.THREADS == const("kThreads")
    assert atmosphere_kernel.LANES == {"sky": const("kSkyLanes"),
                                       "transmittance": const("kTransmittanceLanes")}
    assert atmosphere_kernel.STEPS == {"sky": const("kInScatteringSteps"),
                                       "transmittance": const("kTransmittanceSteps")}
    assert chip_smoke.ATMO_STEPS == {"sky_lut": 30, "transmittance_lut": 40}


@pytest.mark.parametrize("kernel", ["sky_lut", "transmittance_lut"])
def test_atmo_work_is_the_frozen_work_a_texel(kernel):
    """chip_smoke's bound of K10 / K11: texels times the frozen serial
    counts (instructions and MUFU a texel), and bytes of the output (and
    K10's LUT and sun vector read once); the larger of the issue-rate and
    SFU terms bounds it."""
    ins, mufu = chip_smoke.SERIAL_WORK[kernel]
    assert (kernel, ins, mufu) in (("sky_lut", 21224, 664),
                                   ("transmittance_lut", 5909, 167))
    lut = 64 * 256 if kernel == "sky_lut" else 0
    nbytes, got_ins, got_mufu = chip_smoke.atmo_work(kernel, 1000, lut)
    assert got_ins == 1000 * ins and got_mufu == 1000 * mufu
    assert nbytes == 16 * 1000 + (16 * lut + 12 if lut else 0)
    bound, by = chip_smoke.bound_us(nbytes, got_ins, got_mufu)
    assert by == "operations"
    assert bound == pytest.approx(max(got_ins / chip_smoke.ALU_OPS_PER_S,
                                      got_mufu / chip_smoke.SFU_OPS_PER_S) * 1e6)
