"""The yardstick's arithmetic: window statistics, interval unions, idle
gaps, the trace's reduction, the seeded reservoir that draws the checked
outputs, the PSNR and SNR, and the plain reference against the
repository's NumPy float64 oracle."""

import math
import statistics

import numpy as np
import pytest
import torch

from skybench import common, traffic
from skybench.reference import atmosphere, clouds, composite


def test_window_mean_is_window_over_count():
    assert common.window_mean_ms(20.0, 1000) == pytest.approx(20.0)
    assert common.window_mean_ms(0.25, 3) == pytest.approx(250.0 / 3)


def test_p99_has_one_percent_beyond():
    values = list(range(1, 1001))
    p = common.p99(values)
    assert p == statistics.quantiles(values, n=100)[98]
    assert sum(v > p for v in values) == 10


def test_union_and_gaps():
    ivs = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert common.union_us(ivs) == pytest.approx(4.0)
    assert common.idle_gaps(ivs, -1.0, 8.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 8.0)]
    assert common.idle_gaps(ivs, 0.0, 3.0) == []


def test_trace_summary_reads_between_markers():
    s = common.TraceSummary()
    ev = [("spin_kernel", 0.0, 10.0), ("tex3_kernel<2, float>", 20.0, 30.0),
          ("gemm", 25.0, 40.0), ("spin_kernel", 100.0, 110.0)]
    s.add_group(ev, wall_s=100e-6, calls=2)
    assert s.busy_s == pytest.approx(20e-6)
    assert s.activities == 2 and s.calls == 2
    assert s.kernel_s["tex3_kernel<2, float>"] == pytest.approx(10e-6)
    s.add_gaps(ev, [("sky:tick|a", 5.0, 35.0), ("sky:tick|b", 35.0, 99.0)])
    assert s.gap_s["sky:tick|a"] == pytest.approx(10e-6)
    assert s.gap_s["sky:tick|b"] == pytest.approx(60e-6)
    with pytest.raises(ValueError):
        s.add_group(ev[1:], wall_s=1.0, calls=1)
    with pytest.raises(ValueError):
        s.add_group(ev[:-1], wall_s=1.0, calls=1)


def test_a_group_survives_the_loss_of_its_earliest_records():
    opening = [("spin_kernel", float(i), i + 0.5) for i in range(common.OPEN_MARKERS)]
    inner = [("k", 10.0, 20.0), ("k", 30.0, 35.0)]
    closing = [("spin_kernel", 50.0, 51.0)]
    for lost in range(common.OPEN_MARKERS):
        s = common.TraceSummary()
        s.add_group(opening[lost:] + inner + closing, wall_s=1.0, calls=1)
        assert s.activities == 2 and s.busy_s == pytest.approx(15e-6)
    # Every opening marker lost, or a marker among the activities: left out.
    stray = [("spin_kernel", 25.0, 26.0)]
    for ev in (inner + closing, opening + inner[:1] + stray + inner[1:] + closing):
        with pytest.raises(ValueError):
            common.TraceSummary().add_group(ev, wall_s=1.0, calls=1)


@pytest.mark.parametrize("size", [1, 2])
def test_reservoir_draws_uniformly_over_the_whole_stream(size):
    items = 40
    counts = np.zeros(items)
    for seed in range(4000):
        picks = traffic.reservoir_picks(2 ** 33 + seed, 3, size, items)
        assert len(picks) == size and len(set(picks)) == size
        counts[picks] += 1
    assert traffic.reservoir_picks(7, 3, size, items) == traffic.reservoir_picks(7, 3, size, items)
    # Each item is kept with chance size / items: the first and last
    # halves of the stream alike, each item within 5 standard deviations.
    p = size / items
    sd = math.sqrt(4000 * p * (1 - p))
    assert np.all(np.abs(counts - 4000 * p) < 5 * sd)
    assert abs(counts[:20].sum() - counts[20:].sum()) < 6 * sd * math.sqrt(20)


def test_psnr_and_snr():
    ref = torch.tensor([0.0, 1.0, 0.5, 0.25])
    out = ref + torch.tensor([0.01, -0.01, 0.01, -0.01])
    assert common.psnr_db(out, ref) == pytest.approx(40.0)
    rms = math.sqrt(float((ref ** 2).mean()))
    assert common.snr_db(out, ref) == pytest.approx(20 * math.log10(rms / 0.01))


def test_reference_matches_the_oracle():
    from oracle import reference as O

    rng = np.random.default_rng(3)
    tl = O.transmittance_lut_ref()
    tt = atmosphere.transmittance_lut()
    assert np.abs(tt.numpy() - tl).max() < 1e-10
    sun = np.array([0.3, 0.4, -0.85])
    sun /= np.linalg.norm(sun)
    sl = O.sky_lut_ref(tl, sun)
    st = atmosphere.sky_lut(tt, tuple(sun))
    assert np.abs(st.numpy() - sl).max() < 1e-9 * np.abs(sl).max()
    large, small, weather = rng.random((16, 16, 16, 4)), rng.random((8, 8, 8, 3)), \
        rng.random((32, 32, 3))
    params = dict(cloud_pos=(1.5, -0.3), detailed_pos=(0.4, 0.2), weather_pos=(0.01, 0.02),
                  time=12.5, density=0.05, cloud_coverage=0.6, light_direction=tuple(sun),
                  light_energy=1.0, light_color=(1.0, 1.0, 1.0), ground_color=(0.27, 0.19, 0.027))
    dirs = composite.map_directions(16).numpy()
    want = O.cloud_march_ref(dirs, params, O.build_pyramid3d_np(large),
                             O.build_pyramid3d_np(small), weather, sl, steps=16)
    tex = clouds.Textures.build(torch.tensor(large), torch.tensor(small), torch.tensor(weather))
    got = clouds.cloud_march(torch.tensor(dirs), clouds.Scene(**params), tex, st, steps=16)
    assert (want[..., 3] > 0.1).mean() > 0.2
    assert np.abs(got.numpy() - want).max() < 1e-8
    eye = rng.normal(size=(6, 7, 3))
    eye /= np.linalg.norm(eye, axis=-1, keepdims=True)
    cf, ct = rng.random((16, 16, 4)), rng.random((16, 16, 4))
    want = O.composite_ref(eye, cf, ct, sl, sl * 0.9, tl, 0.3, 2.0, sun)
    got = composite.composite(torch.tensor(eye), torch.tensor(cf), torch.tensor(ct), st,
                              st * 0.9, tt, 0.3, 2.0, tuple(sun))
    assert np.abs(got.numpy() - want).max() < 1e-10
