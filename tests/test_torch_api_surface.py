"""The last of the JAX package's public surface in the PyTorch port, on the
CPU: `PI`, `srgb_to_linear` and `normalize(v, axis)` (ops/math.py),
`VIEW_POS_MM` (models/compositor.py), the `chunk` keyword of the sliced
cone bake (`cone_occupancy_slice`, `bake_cone_cells`), the sRGB light
colour of `FrameData.update_light_data`, and an AST walk that every public
name and parameter of `cloudscape_tpu/` has its counterpart in
`cloudscape_tpu_torch/`, but for the exclusions listed with their reasons.

Measured on the CPU: the sliced bake is bitwise alike for every `chunk`;
its occupancy is bitwise JAX's and its cone densities 7.5e-4 at most from
JAX's (the shell radius's FMA rounding, tests/test_torch_exact.py),
98.57 dB. The sRGB colour of `update_light_data` now comes from torch's
`pow`: on the 768 channels of 256 colours of 8-bit levels it differs from
the NumPy float32 formula it replaces on 480 channels and from JAX's on
459, by at most 4 float32 ulps (NumPy's and XLA's float32 `pow` are not
correctly rounded; torch's is on such short vectors).
"""

import ast
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu.config import SunState as JSun
from cloudscape_tpu.models import compositor as jcomp
from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.models.density import MarchParams as JParams
from cloudscape_tpu.models.packs import make_noise_pack
from cloudscape_tpu.ops import math as jmath
from cloudscape_tpu.ops.noise import (generate_base_noise, generate_detail_noise,
                                      generate_weather)
from cloudscape_tpu.temporal import FrameData as JFrameData
from cloudscape_tpu.utils.image import psnr
from cloudscape_tpu_torch.config import SunState
from cloudscape_tpu_torch.models import compositor as tcomp
from cloudscape_tpu_torch.models import march_fast as tmf
from cloudscape_tpu_torch.models.density import MarchParams
from cloudscape_tpu_torch.models.packs import noise_pack_from_numpy
from cloudscape_tpu_torch.ops import math as tmath
from cloudscape_tpu_torch.temporal import FrameData

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (8, 64, 64)

# Modules of the JAX package the port has no counterpart for, each with its
# reason (ROADMAP "Leave out").
EXCLUDED = {
    # The Pallas TPU kernels: each has a hand-written CUDA kernel in
    # cloudscape_tpu_torch/csrc/ behind the wrapper of the module it serves
    # (ops/accum.py, ops/compact.py, ops/segscan.py, ops/noise_kernel.py).
    "ops/accum_pallas.py": "K1: csrc/accum.cu behind ops/accum.py",
    "ops/compact_pallas.py": "K2: csrc/compact.cu behind ops/compact.py",
    "ops/noise_pallas.py": "K4–K6: csrc/noise.cu behind ops/noise_kernel.py",
    "ops/segscan_pallas.py": "K3: csrc/segscan.cu behind ops/segscan.py",
    # The optional ctypes accelerator of the host asset pipeline, whose
    # outputs are by design its Python fallback's: BMP decoding and slicing
    # are utils/assets.py's, the mips and brick tables are built on the card.
    "utils/_native.py": "the ctypes asset accelerator; utils/assets.py",
    "utils/build_native.py": "builds the ctypes accelerator's library",
}


# ------------------------------------------------------------------ math

def test_pi_and_srgb_to_linear_match_jax():
    """tests/test_math.py's check on the port (rtol 1e-5, atol 1e-7), and
    against JAX's function on the same float32 inputs."""
    assert tmath.PI == jmath.PI and tmath.PI_CLOUDS == jmath.PI_CLOUDS
    c = np.linspace(0, 1, 101)
    got = tmath.srgb_to_linear(torch.tensor(c, dtype=torch.float32))
    assert got.dtype == torch.float32
    want = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jmath.srgb_to_linear(jnp.asarray(c, jnp.float32))),
        rtol=1e-5, atol=1e-7)
    assert abs(float(tmath.srgb_to_linear(1.0)) - 1.0) < 1e-6


def test_srgb_to_linear_dtypes():
    """Computed in the input's float dtype; integers and bools in float32;
    anything `torch.as_tensor` takes."""
    c64 = tmath.srgb_to_linear(torch.tensor([0.02, 0.5], dtype=torch.float64))
    assert c64.dtype == torch.float64
    np.testing.assert_allclose(c64.numpy(), [0.02 / 12.92, ((0.5 + 0.055) / 1.055) ** 2.4],
                               rtol=1e-15)
    assert tmath.srgb_to_linear([0, 1]).dtype == torch.float32
    assert tmath.srgb_to_linear(np.array([True, False])).tolist() == [1.0, 0.0]


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_normalize_axes_match_jax(axis):
    """`normalize(v, axis)` against JAX's over axes −1, 0 and 1 of a
    [3, 3, 3] tensor (rtol 1e-6), unit length along the axis; the default
    is bitwise the trailing-axis form every march calls."""
    v = np.random.default_rng(3).normal(size=(3, 3, 3)).astype(np.float32)
    got = tmath.normalize(torch.from_numpy(v), axis=axis).numpy()
    want = np.asarray(jmath.normalize(jnp.asarray(v), axis=axis))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(got, axis=axis), 1.0, rtol=1e-6)
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(tmath.normalize(t).numpy(),
                                  (t / tmath.norm3(t)[..., None]).numpy())


def test_normalize_other_lengths():
    """An axis of another length than 3 normalizes too, as JAX's does."""
    v = np.random.default_rng(4).normal(size=(5, 7)).astype(np.float32)
    for axis in (0, 1):
        np.testing.assert_allclose(
            tmath.normalize(torch.from_numpy(v), axis=axis).numpy(),
            np.asarray(jmath.normalize(jnp.asarray(v), axis=axis)), rtol=1e-6, atol=1e-7)


def test_view_pos_matches_jax():
    np.testing.assert_array_equal(np.asarray(tcomp.VIEW_POS_MM, np.float32),
                                  np.asarray(jcomp.VIEW_POS_MM))


# ------------------------------------------------------- the light colour

def _numpy_srgb_to_linear(c):
    """The NumPy float32 formula `update_light_data` used before the port's
    `srgb_to_linear` took its place."""
    c = np.asarray(c, np.float32)
    return np.where(c <= np.float32(0.04045), c / np.float32(12.92),
                    np.power((c + np.float32(0.055)) / np.float32(1.055),
                             np.float32(2.4))).astype(np.float32)


def test_update_light_data_srgb():
    """`update_light_data(srgb_color=True)` stores `srgb_to_linear` of the
    float32 colour, widened to float64, bitwise; within 4 float32 ulps of
    the replaced NumPy formula and of JAX's FrameData on every 8-bit level;
    without srgb_color the colour is kept as given."""
    levels = np.arange(256) / 255.0
    for k in range(256):
        color = (levels[k], levels[(7 * k) % 256], levels[(13 * k) % 256])
        f, jf = FrameData(), JFrameData()
        f.update_light_data(SunState(direction=(0.3, 0.4, -0.8), color=color), True)
        jf.update_light_data(JSun(direction=(0.3, 0.4, -0.8), color=color), True)
        assert f.light_color.dtype == np.float64
        want = tmath.srgb_to_linear(torch.tensor(color, dtype=torch.float32))
        np.testing.assert_array_equal(f.light_color, want.numpy().astype(np.float64))
        got32 = f.light_color.astype(np.float32).view(np.int32)
        for other in (_numpy_srgb_to_linear(color), jf.light_color.astype(np.float32)):
            assert np.abs(got32 - other.view(np.int32)).max() <= 4, (color, other)
    f = FrameData()
    f.update_light_data(SunState(direction=(0.0, 1.0, 0.0), color=(0.5, 0.25, 1.0)))
    np.testing.assert_array_equal(f.light_color, [0.5, 0.25, 1.0])


# ------------------------------------------------------ the sliced bake

@pytest.fixture(scope="module")
def bake_scene():
    jn = make_noise_pack(generate_base_noise(16, seed=1),
                         generate_detail_noise(16, seed=2),
                         generate_weather(64, seed=3))
    tn = noise_pack_from_numpy([np.asarray(a) for a in jn.large],
                               [np.asarray(a) for a in jn.small],
                               np.asarray(jn.weather), device="cpu")
    sun = np.array([0.3, 0.4, -0.85])
    jp = JParams.create(
        cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
        weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=0.6,
        light_direction=sun / np.linalg.norm(sun),
        ground_color=np.array([0.27, 0.19, 0.027]))
    tp = MarchParams.from_numpy({k: np.asarray(v) for k, v in vars(jp).items()},
                                device="cpu")
    return jp, tp, jmf.BrickPack.from_noise(jn), tmf.BrickPack.from_noise(tn)


def test_cone_occupancy_slice_chunk(bake_scene):
    """`cone_occupancy_slice` is bitwise alike for chunk 16384 (JAX's
    default), 1000 and the whole slice, bitwise JAX's, and a call without
    the keyword is the 16384 one; over two slices, one ragged."""
    jp, tp, jb, tb = bake_scene
    n = int(np.prod(RES))
    outs = {}
    for chunk in (16384, 1000, n, None):
        occ = torch.zeros(n, dtype=torch.bool)
        for i0, count in ((0, 20000), (20000, n - 20000)):
            kw = {} if chunk is None else dict(chunk=chunk)
            tmf.cone_occupancy_slice(occ, i0, tp, tb, count, res=RES, **kw)
        outs[chunk] = occ.numpy()
    for chunk in (1000, n, None):
        np.testing.assert_array_equal(outs[chunk], outs[16384])
    want = np.asarray(jmf.cone_occupancy_slice(jnp.zeros(n, bool), 0, jp, jb, n,
                                               res=RES, chunk=16384))
    np.testing.assert_array_equal(outs[16384], want)
    assert 0 < want.sum() < n


def test_bake_cone_cells_chunk(bake_scene):
    """`bake_cone_cells` is bitwise alike for chunk 16384, 1000 and the
    whole capacity (and without the keyword), and its cone densities meet
    JAX's at ≥ 80 dB (the gate of tests/test_torch_engine.py's cone
    table; 98.57 dB measured)."""
    jp, tp, jb, tb = bake_scene
    n = int(np.prod(RES))
    idx = tmf.cone_occupancy_indices(tp, tb, res=RES, chunk=4096)
    cap = idx.shape[0]
    outs = {}
    for chunk in (16384, 1000, cap, None):
        vol = torch.zeros(n + 1)
        kw = {} if chunk is None else dict(chunk=chunk)
        for i0, count in ((0, 5000), (5000, cap - 5000)):
            tmf.bake_cone_cells(vol, idx, i0, tp, tb, count, light_steps=6,
                                res=RES, **kw)
        outs[chunk] = vol.numpy()
    for chunk in (1000, cap, None):
        np.testing.assert_array_equal(outs[chunk], outs[16384])
    want = np.asarray(jmf.bake_cone_cells(jnp.zeros(n), jnp.asarray(idx.numpy()), 0,
                                          jp, jb, cap, light_steps=6, res=RES,
                                          chunk=16384))
    assert (want > 0).any()
    assert psnr(outs[16384][:n], want) >= 80.0


# ---------------------------------------------------------- the surface

def _public_surface(path):
    """{name: parameter names, or None}: a module's public functions,
    classes, constants, and its classes' methods and fields."""
    def params(f):
        a = f.args
        return ([x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
                + [x.arg for x in (a.vararg, a.kwarg) if x is not None])

    def private(name):
        return name.startswith("_") and not name.startswith("__")

    out = {}
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = params(sub)
                elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    out[f"{node.name}.{sub.target.id}"] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                if isinstance(t, ast.Name):
                    out[t.id] = None
    return {k: v for k, v in out.items() if not any(private(p) for p in k.split("."))}


def test_public_surface_is_ported():
    """Every public name and parameter name of every module of
    `cloudscape_tpu/` is in the same module of `cloudscape_tpu_torch/`,
    but for EXCLUDED."""
    jroot = os.path.join(ROOT, "cloudscape_tpu")
    troot = os.path.join(ROOT, "cloudscape_tpu_torch")
    missing, modules = [], 0
    for dirpath, _, files in os.walk(jroot):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), jroot)
            if rel.replace(os.sep, "/") in EXCLUDED:
                continue
            modules += 1
            tpath = os.path.join(troot, rel)
            if not os.path.exists(tpath):
                missing.append(f"{rel}: the module")
                continue
            jsurf, tsurf = _public_surface(os.path.join(jroot, rel)), _public_surface(tpath)
            for name, jparams in jsurf.items():
                if name not in tsurf:
                    missing.append(f"{rel}: {name}")
                elif jparams is not None and tsurf[name] is not None:
                    missing += [f"{rel}: {name}({p}=)" for p in jparams
                                if p not in tsurf[name]]
    assert modules >= 24
    assert not missing, "not in the port:\n" + "\n".join(missing)


def test_exclusions_exist():
    """Every excluded module is in the JAX package and not in the port, so
    the list holds nothing stale."""
    for rel in EXCLUDED:
        assert os.path.exists(os.path.join(ROOT, "cloudscape_tpu", rel)), rel
        assert not os.path.exists(os.path.join(ROOT, "cloudscape_tpu_torch", rel)), rel
