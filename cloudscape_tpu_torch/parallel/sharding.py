"""Multi-device rendering: hemisphere rows sharded over a 1-D device mesh.

The port of `cloudscape_tpu.parallel.sharding`. Rays are independent and
share only read-only inputs, so the hemisphere's row axis is split over the
mesh (`P("rays")`), the noise, its textures, the cone cache, parameters and LUTs
are replicated (`P()`), and shards talk only where the JAX package's do: the
v3 cull prepass exchanges one boundary row for its dilations
(`models/march_fast.py` `_halo_rows`), and a frame's mean luminance is
summed over the mesh (`psum`).

The JAX package runs `jax.shard_map` over a `Mesh` in one process; so does
this module, with one thread per shard:

- `Mesh` is an ordered tuple of `torch.device`s with one axis name.
  Devices may repeat: `make_mesh(["cuda:0"] * 4)` is a 4-shard mesh on one
  card, `make_mesh(["cpu"] * 8)` the counterpart of the JAX tests' virtual
  8-device CPU mesh, `make_mesh()` every visible card.
- `shard_map(fn, mesh, in_specs, out_specs)` runs fn once per shard, each in
  a thread of its own. A `P(axis)` input is split evenly by rows (an
  indivisible count raises ValueError); a `P()` input is replicated, moved
  once to each distinct device of the mesh and not copied where it is
  there already. A `P(axis)` output is concatenated by rows on the mesh's
  first device; a `P()` output is shard 0's.
- Inside fn, the collectives `axis_size`, `axis_index`, `ppermute` and
  `psum` read the shard's axis from a thread-local binding, so the marches
  keep the JAX signatures (`axis_name=None` off the mesh).

Every shard thread issues its work on the caller's current stream of each
device, so the shards on one card share one stream: a halo row is read
after it was written, and two cooperative launches (kernels K2 and K3,
each of which needs its whole grid resident) never run at once. A copy
between devices is PyTorch's, ordered after the producer's work on both
devices' current streams. A shard that raises aborts the exchange, the
others stop at their next collective, and the call re-raises the failing
shard's exception; a collective that waits longer than the call's timeout
fails the call with TimeoutError.

No communication happens inside the march otherwise, so
`render_hemisphere_sharded` of the scan march is bitwise the single-device
render (tests/test_torch_sharding.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from cloudscape_tpu_torch.models import atmosphere
from cloudscape_tpu_torch.models.density import MarchParams, NoisePack
from cloudscape_tpu_torch.models.march import march
from cloudscape_tpu_torch.ops.octmap import texel_directions

# How long a shard waits at a collective for the other shards, in seconds:
# longer than any shard's work between two exchanges at the engine's sizes.
EXCHANGE_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: shard i runs on devices[i]; its one axis is
    `axis_name`."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "rays"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices))


class P(tuple):
    """A partition spec, as `jax.sharding.PartitionSpec`: `P(axis)` splits
    an argument's leading dimension over the mesh axis, `P()` replicates
    it."""

    def __new__(cls, *names):
        return super().__new__(cls, names)


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence[Any]] = None,
              axis_name: str = "rays") -> Mesh:
    """A 1-D mesh over `devices` (devices or their names; repeats allowed),
    by default every visible CUDA device; its one axis shards hemisphere
    rows."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: name the mesh's devices "
                               "(e.g. make_mesh(['cpu'] * 8))")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(_canonical(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, axis_name)


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """fn over every tensor of a tree of dataclasses (MarchParams, NoisePack,
    BrickPack, ConeCache and their textures), tuples, lists and dicts;
    other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def replicate(tree, devices: Sequence[torch.device]) -> list:
    """One copy of `tree` per entry of `devices`: moved once to each
    distinct device (a tensor already there is not copied) and shared by
    the entries that repeat it."""
    copies = {}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = tree_map(lambda t, d=d: t.to(d), tree)
        out.append(copies[d])
    return out


# ---------------------------------------------------------------- collectives


class ShardAborted(RuntimeError):
    """A collective's exchange was aborted because another shard failed."""


class _Axis:
    """One shard_map call's mesh axis: the slots and the barrier through
    which its collectives exchange values."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.slots: list = [None] * size
        self.barrier = threading.Barrier(size, timeout=timeout)

    def _wait(self) -> None:
        try:
            self.barrier.wait()
        except threading.BrokenBarrierError:
            raise ShardAborted("a collective's exchange was aborted") from None

    def exchange(self, index: int, value) -> list:
        """Post `value` as shard `index`'s and return every shard's values,
        once all have posted. The second wait keeps a shard's next post
        from overwriting a slot that another shard has not read yet."""
        self.slots[index] = value
        self._wait()
        got = list(self.slots)
        self._wait()
        return got


_BOUND = threading.local()


def _bound(axis_name: str) -> Tuple[_Axis, int]:
    axes = getattr(_BOUND, "axes", None) or {}
    if axis_name not in axes:
        raise NameError(f"unbound axis name {axis_name!r}: collectives run only "
                        "inside shard_map over a mesh with that axis")
    return axes[axis_name]


def axis_size(axis_name: str) -> int:
    """The number of shards on the mesh axis (`jax.lax.axis_size`)."""
    return _bound(axis_name)[0].size


def axis_index(axis_name: str) -> int:
    """This shard's index on the mesh axis (`jax.lax.axis_index`)."""
    return _bound(axis_name)[1]


def ppermute(x: torch.Tensor, axis_name: str, perm) -> torch.Tensor:
    """`jax.lax.ppermute`: shard src sends x to shard dst for each (src, dst)
    of perm; a shard that receives nothing gets zeros. The result lies on
    this shard's x's device."""
    axis, i = _bound(axis_name)
    got = axis.exchange(i, x)
    src = [s for s, d in perm if d == i]
    if len(src) > 1:
        raise ValueError(f"ppermute: shard {i} receives from {src}")
    if not src:
        return torch.zeros_like(x)
    return got[src[0]].to(x.device)


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """`jax.lax.psum`: the sum of x over the shards, added in shard order on
    every shard (so every shard holds the same value), on x's device."""
    axis, i = _bound(axis_name)
    got = axis.exchange(i, x)
    total = got[0].to(x.device)
    for v in got[1:]:
        total = total + v.to(x.device)
    return total


# ---------------------------------------------------------------- shard_map


def _is_sharded(spec, mesh: Mesh) -> bool:
    if spec not in (P(), P(mesh.axis_name)):
        raise ValueError(f"partition spec {spec!r}: this mesh takes P() or "
                         f"P({mesh.axis_name!r})")
    return spec == P(mesh.axis_name)


def _split_rows(a, size: int, what: str):
    if not isinstance(a, torch.Tensor) or a.dim() == 0:
        raise ValueError(f"{what}: only a tensor with a leading dimension can "
                         "be sharded")
    n = a.shape[0]
    if n % size:
        raise ValueError(f"{what}: {n} rows do not split evenly over the "
                         f"mesh's {size} devices")
    r = n // size
    return [a[i * r:(i + 1) * r] for i in range(size)]


def _gather(values: list, spec, mesh: Mesh):
    if _is_sharded(spec, mesh):
        first = mesh.devices[0]
        return torch.cat([v.to(first) for v in values], dim=0)
    return values[0]


@contextlib.contextmanager
def _shard_context(mesh: Mesh, index: int, axis: _Axis, streams):
    """A shard thread's binding: its axis, the caller's current stream of
    each CUDA device of the mesh, and its own device as the current one."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        if mesh.devices[index].type == "cuda":
            stack.enter_context(torch.cuda.device(mesh.devices[index]))
        _BOUND.axes = {mesh.axis_name: (axis, index)}
        try:
            yield
        finally:
            _BOUND.axes = {}


def shard_map(fn: Callable, mesh: Mesh, in_specs: Sequence, out_specs,
              timeout: float = EXCHANGE_TIMEOUT_S) -> Callable:
    """`jax.shard_map` over a 1-D mesh: the returned function splits and
    replicates its arguments by `in_specs` (one spec per argument), runs
    fn(*shard_args) once per shard, each in its own thread with the mesh
    axis bound for the collectives, and assembles the results by
    `out_specs` (one spec, or a tuple of specs for a tuple result)."""

    def call(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map: {len(args)} arguments, {len(in_specs)} "
                             "in_specs")
        size = mesh.size
        shard_args = [[None] * len(args) for _ in range(size)]
        for k, (a, spec) in enumerate(zip(args, in_specs)):
            if _is_sharded(spec, mesh):
                parts = [p.to(d) for p, d in zip(
                    _split_rows(a, size, f"shard_map argument {k}"), mesh.devices)]
            else:
                parts = replicate(a, mesh.devices)
            for i in range(size):
                shard_args[i][k] = parts[i]
        streams = [torch.cuda.current_stream(d) for d in mesh.distinct_devices()
                   if d.type == "cuda"]
        axis = _Axis(size, timeout)
        results: list = [None] * size
        errors: list = []  # (shard, exception) in the order they were raised
        lock = threading.Lock()

        def work(i: int) -> None:
            try:
                with _shard_context(mesh, i, axis, streams):
                    results[i] = fn(*shard_args[i])
            except BaseException as e:  # noqa: BLE001 — re-raised by the caller
                with lock:
                    errors.append((i, e))
                axis.barrier.abort()

        threads = [threading.Thread(target=work, args=(i,), name=f"shard-{i}",
                                    daemon=True) for i in range(size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            own = [e for _, e in errors if not isinstance(e, ShardAborted)]
            if own:
                raise own[0]
            raise TimeoutError(f"shard_map: a collective waited more than "
                               f"{timeout} s for the other shards")
        if isinstance(out_specs, P):
            return _gather(results, out_specs, mesh)
        return tuple(_gather([r[k] for r in results], s, mesh)
                     for k, s in enumerate(out_specs))

    return call


# ------------------------------------------------------------ sharded renders


def _march_for(kernel: str, steps: int, light_steps: int,
               axis_name: str = "rays", v3_policy=(1.0, 0.75, 0.75)):
    """The per-shard march of `render_hemisphere_sharded`: "reference" (the
    scan march on a NoisePack), "fast" (the exact brick march on a
    BrickPack), "fast2" (the staged v2 march) or "fast3" (the v3 cell-gated
    march; its prepass dilations exchange one boundary row with the
    neighbouring shards through `_halo_rows`, so the sharded cell gate is
    bitwise the unsharded one). For fast2 and fast3 noise is a (BrickPack,
    ConeCache) pair, both replicated. v3_policy = (ray_keep, cell_keep,
    hot_keep) buckets, sized per shard: keep them overflow-free. The knobs
    are the JAX function's."""
    if kernel == "fast3":
        from cloudscape_tpu_torch.models.march_fast import march_bricks_v3

        ps = max(1, steps // 4)
        while steps % ps:
            ps -= 1
        rk, ck, hk = v3_policy

        def f3(d, p, n, s):
            bricks, cone = n
            return march_bricks_v3(
                d, p, bricks, s, steps=steps, light_steps=light_steps,
                chunk=16384, cell_keep_frac=ck, hot_keep_frac=hk,
                cone_cache=cone, ray_keep_frac=rk, prepass_steps=ps,
                ray_stride=2, axis_name=axis_name)

        return f3
    if kernel == "fast2":
        from cloudscape_tpu_torch.models.march_fast import march_bricks_v2

        def f2(d, p, n, s):
            bricks, cone = n
            return march_bricks_v2(d, p, bricks, s, steps=steps,
                                   light_steps=light_steps, chunk=16384,
                                   capacity_frac=0.3, cone_cache=cone)

        return f2
    if kernel == "fast":
        from cloudscape_tpu_torch.models.march_fast import march_bricks

        return lambda d, p, n, s: march_bricks(
            d, p, n, s, steps=steps, light_steps=light_steps, chunk=16384,
            capacity_frac=0.3)
    if kernel != "reference":
        raise ValueError(f"unknown kernel {kernel!r}")
    return lambda d, p, n, s: march(d, p, n, s, steps=steps,
                                    light_steps=light_steps)


def render_hemisphere_sharded(mesh: Mesh, texture_size: int,
                              params: MarchParams, noise, sky_img,
                              steps: int = 128, light_steps: int = 6,
                              axis_name: str = "rays",
                              kernel: str = "reference",
                              v3_policy=(1.0, 0.75, 0.75)):
    """The whole hemisphere map with its rows sharded over the mesh →
    [N, N, 4] on the mesh's first device. texture_size must be a multiple
    of the mesh size. noise: a NoisePack ("reference"), a BrickPack
    ("fast") or a (BrickPack, ConeCache) pair ("fast2", "fast3"),
    replicated with params and sky_img."""
    if texture_size % mesh.size:
        raise ValueError(f"texture_size {texture_size} is not a multiple of "
                         f"the mesh size {mesh.size}")
    dirs = texel_directions(texture_size, device=mesh.devices[0])
    return shard_map(
        _march_for(kernel, steps, light_steps, axis_name, tuple(v3_policy)),
        mesh, in_specs=(P(axis_name), P(), P(), P()),
        out_specs=P(axis_name))(dirs, params, noise, sky_img)


def full_frame_step_sharded(params: MarchParams, noise: NoisePack, tlut,
                            sun_direction, *, texture_size: int, steps: int,
                            light_steps: int, mesh: Mesh,
                            axis_name: str = "rays"):
    """One whole frame over the mesh:

    1. the sky-view LUT, rendered once on tlut's device and replicated (20 k
       rays: cheaper to replicate than to shard and gather);
    2. the hemisphere's scan march, rows sharded;
    3. the frame's mean luminance, each shard's sum `psum`'d over the mesh.

    Returns (hemisphere [N, N, 4] on the mesh's first device, sky LUT
    [100, 200, 4], mean luminance, a 0-d tensor)."""
    sky_img = atmosphere.sky_lut(tlut, sun_direction)

    def shard_fn(d, p, n, s):
        tile = march(d, p, n, s, steps=steps, light_steps=light_steps)
        total = psum(torch.sum(tile[..., :3]), axis_name)
        return tile, total / (3.0 * texture_size * texture_size)

    dirs = texel_directions(texture_size, device=mesh.devices[0])
    tile, mean_lum = shard_map(
        shard_fn, mesh, in_specs=(P(axis_name), P(), P(), P()),
        out_specs=(P(axis_name), P()))(dirs, params, noise, sky_img)
    return tile, sky_img, mean_lum
