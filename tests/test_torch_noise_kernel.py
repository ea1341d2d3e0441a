"""The port's noise generators (`ops/noise_kernel.py`, K4–K6) ≡ the JAX
package's Pallas noise kernels, on the CPU.

On the CPU the wrappers take their plain versions (the `ops/noise.py`
generators) and the Pallas kernels run in interpret mode, as
tests/test_noise_pallas.py runs them. The gate is that file's, atol 2e-5;
base noise runs at 8³ so that no case here needs the `slow` mark. The
CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from cloudscape_tpu.ops import noise_pallas
from cloudscape_tpu_torch.models import packs
from cloudscape_tpu_torch.ops import noise, noise_kernel

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

CASES = [
    ("generate_base_noise", "generate_base_noise_pallas", 8, 3, (8, 8, 8, 4)),
    ("generate_detail_noise", "generate_detail_noise_pallas", 16, 9, (16, 16, 16, 3)),
    ("generate_weather", "generate_weather_pallas", 64, 1, (64, 64, 3)),
]


@pytest.mark.parametrize("fn,pallas_fn,size,seed,shape", CASES)
def test_matches_pallas_kernels(fn, pallas_fn, size, seed, shape):
    want = np.asarray(getattr(noise_pallas, pallas_fn)(size, seed))
    got = getattr(noise_kernel, fn)(size, seed, "cpu").numpy()
    assert got.shape == want.shape == shape and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("fn,pallas_fn,size,seed,shape", CASES)
def test_cpu_wrapper_is_the_plain_version(fn, pallas_fn, size, seed, shape):
    """On the CPU the wrapper returns the plain version bitwise, and counts
    no kernel launch."""
    before = dict(noise_kernel.launches)
    got = getattr(noise_kernel, fn)(size, seed + 1, torch.device("cpu"))
    want = getattr(noise, fn)(size, seed + 1)
    assert torch.equal(got, want)
    assert noise_kernel.launches == before
    assert torch.equal(getattr(noise_kernel, fn)(size, seed + 1, device="cpu"), want)


@pytest.mark.parametrize("fn", ["generate_base_noise", "generate_detail_noise",
                                "generate_weather"])
def test_other_devices_raise(fn):
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(noise_kernel, fn)(4, 0, "meta")


def test_procedural_pack_goes_through_the_wrappers(monkeypatch):
    """`procedural_noise_pack` calls the three wrappers with its sizes,
    seed and device, and keeps the pack's layout and mip chains."""
    calls = []
    for name in ("generate_base_noise", "generate_detail_noise", "generate_weather"):
        real = getattr(noise_kernel, name)

        def spy(size, seed, device=None, _real=real, _name=name):
            calls.append((_name, size, seed, str(device)))
            return _real(size, seed, device)

        monkeypatch.setattr(noise_kernel, name, spy)
    pack = packs.procedural_noise_pack(5, base_size=8, detail_size=4,
                                       weather_size=16, device="cpu")
    assert calls == [("generate_base_noise", 8, 5, "cpu"),
                     ("generate_detail_noise", 4, 5, "cpu"),
                     ("generate_weather", 16, 5, "cpu")]
    assert [tuple(v.shape) for v in pack.large] == [
        (8, 8, 8, 4), (4, 4, 4, 4), (2, 2, 2, 4), (1, 1, 1, 4)]
    assert [tuple(v.shape) for v in pack.small] == [
        (4, 4, 4, 3), (2, 2, 2, 3), (1, 1, 1, 3)]
    assert tuple(pack.weather.shape) == (16, 16, 3)
    want = packs.make_noise_pack(noise.generate_base_noise(8, 5),
                                 noise.generate_detail_noise(4, 5),
                                 noise.generate_weather(16, 5))
    for a, b in zip(pack.large + pack.small + (pack.weather,),
                    want.large + want.small + (want.weather,)):
        assert torch.equal(a, b)
