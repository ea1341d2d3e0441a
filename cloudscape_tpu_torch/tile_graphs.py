"""CUDA graphs of the serving tick's v3 tile (`V3TileGraphs`).

A fast3 tile that takes the v3 arm (`engine._march_tile_v3`) is some 600
to 2,300 small launches whose shapes are fixed by the tile's edge, its
live-cell bucket, the march's steps and its chunk: nothing in the arm
reads a count back to the host (its compactions fill fixed capacities and
its chunk loops have static bounds). So a graph captured once per bucket
replays a tile in one launch. The graphs read static input tensors:

- the tile's directions and the sky-LUT image, copied in on every tick
  (the image is 320 KB; a tick's slot is a view of a ring written in
  place);
- the snapshot's march parameters and cone table, copied in when their
  source changes: another object (a rotation, a restore) or an in-place
  write (its version counter).

The noise textures are the engine's own, read where they are (the cache
starts over if the engine's `BrickPack` is another). A replay then reads
what the eager call would read and runs the same kernels at the same
sizes and alignments on the same stream, so its tile is the eager tile,
bitwise (tests/test_torch_v3_graphs.py, on the card).

All of an engine's graphs share one memory pool; they replay in order on
the current stream, and the caller copies a replay's output out before the
next replay, so a graph's temporaries may overlap another's output. Each
bucket is captured after one eager warm-up call on a side stream (the
kernels and torch's lazy state are then loaded outside the capture).

The kernel wrappers count the launches they make (`launches`, `samples`,
`sizes`): the warm-up's count, the capture's do not (it launches nothing:
`_cuda.capturing`), and a replay launches its kernels through no wrapper,
so it adds nothing to them either. A replay's kernels are on the device's
trace, each under its own name, and the engine counts the replays
(`engine.v3_graph_replays`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from cloudscape_tpu_torch.ops import _cuda


class V3TileGraphs:
    """One engine's v3 tile graphs, for the inputs' shapes, the march's
    keywords (steps, light steps) and the cone table's geometry and extent
    last loaded. `march(dirs, params, bricks, cone_cache, sky_img, bucket,
    **keywords)` is the arm the graphs capture; `load` copies a tick's
    inputs in, `capture` records every bucket not captured yet, `replay`
    launches one, and `eager` calls the arm a graph replays."""

    def __init__(self, device, march: Callable):
        self.device = torch.device(device)
        self._march = march
        self._pool = None
        self._key = None
        self._kw: Dict[str, object] = {}
        # bucket -> (its graph, the replay's tile in the shared pool)
        self._graphs: Dict[float, tuple] = {}
        self._bricks = None
        self._dirs = self._sky = None
        self._params = self._params_src = self._params_versions = None
        self._cone = self._cone_src = self._cone_version = None

    def __deepcopy__(self, memo):
        """A copied engine starts with no graphs: a graph cannot be copied,
        and it reads the inputs of the engine that captured it."""
        return V3TileGraphs(self.device, self._march)

    @staticmethod
    def _key_of(dirs, cone_cache, sky_img, keywords) -> tuple:
        table = cone_cache.table
        return (tuple(sorted(keywords.items())), tuple(dirs.shape), tuple(sky_img.shape),
                tuple(table.texels.shape), table.texels.dtype, table.dims,
                table.channels, table.wrap, cone_cache.extent)

    def load(self, dirs, params, bricks, cone_cache, sky_img, **keywords) -> None:
        """Copy a tick's inputs into the static tensors (allocating them,
        and dropping every graph, when the march's keywords, an input's
        shape, the cone table's geometry or the noise textures change)."""
        table = cone_cache.table
        key = self._key_of(dirs, cone_cache, sky_img, keywords)
        if key != self._key or bricks is not self._bricks:
            self._graphs.clear()
            self._key, self._bricks, self._kw = key, bricks, dict(keywords)
            self._dirs = torch.empty_like(dirs, memory_format=torch.contiguous_format)
            self._sky = torch.empty_like(sky_img, memory_format=torch.contiguous_format)
            self._params = type(params)(**{
                f.name: torch.empty_like(getattr(params, f.name))
                for f in dataclasses.fields(params)})
            self._cone = dataclasses.replace(cone_cache, table=dataclasses.replace(
                table, texels=torch.empty_like(
                    table.texels, memory_format=torch.contiguous_format)))
            self._params_src = self._cone_src = None
        self._dirs.copy_(dirs)
        self._sky.copy_(sky_img)
        fields = [f.name for f in dataclasses.fields(params)]
        versions = tuple(getattr(params, f)._version for f in fields)
        if params is not self._params_src or versions != self._params_versions:
            for f in fields:
                getattr(self._params, f).copy_(getattr(params, f))
            self._params_src, self._params_versions = params, versions
        texels = cone_cache.table.texels
        if cone_cache is not self._cone_src or texels._version != self._cone_version:
            self._cone.table.texels.copy_(texels)
            self._cone_src, self._cone_version = cone_cache, texels._version

    def eager(self, bucket: float):
        """The arm's eager call of `bucket` on the loaded inputs: what its
        graph replays."""
        return self._march(self._dirs, self._params, self._bricks, self._cone,
                           self._sky, bucket, **self._kw)

    def capture(self, buckets) -> int:
        """Capture the graph of each of `buckets` not captured yet, from
        the largest, on the loaded inputs; returns how many were
        captured."""
        todo = sorted((b for b in set(buckets) if b not in self._graphs), reverse=True)
        if not todo:
            return 0
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            for b in todo:
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    self.eager(b)
                main.wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                _cuda.capturing = True
                try:
                    with torch.cuda.graph(graph, pool=self._pool):
                        out = self.eager(b)
                finally:
                    _cuda.capturing = False
                self._graphs[b] = graph, out
        return len(todo)

    def replay(self, bucket: float) -> torch.Tensor:
        """Launch the bucket's graph on the current stream; returns its
        output tile, valid until the next replay."""
        graph, out = self._graphs[bucket]
        with torch.cuda.device(self.device):
            graph.replay()
        return out
