"""The node's frame chain replayed as one CUDA graph a frame.

:class:`~mrs_optic_flow_tpu_torch.runtime.node.OpticFlowNode` issues a
frame's whole chain as one function on static buffers (its ``body``): the
frame and the packed parameter vector copied from pinned host memory into
static device inputs, grayscale and crop, the engine step, the geometry,
scale/rotation, the carry update, and one copy of the ``summary`` vector
into pinned host memory.  On a CUDA device :class:`FrameGraphs` runs a
key's body once eagerly on its capture stream, captures it as a
``torch.cuda.CUDAGraph``, and from the next frame on replays the graph: one
launch from the host a frame in place of about 1,400 eager ones, and one
host synchronisation, on the readback.  On the CPU the body runs as it is,
so the CPU and the card share the plumbing.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from mrs_optic_flow_tpu_torch.ops import cuda_kernels

#: the kernel wrappers whose ``LAUNCHES`` a replay adds to
WRAPPERS = tuple(getattr(cuda_kernels, name) for name in cuda_kernels.SOURCES)


class _InputsRead(TorchFunctionMode):
    """Collects, while a graph is captured, every tensor a torch call reads
    that the capture did not make: the static buffers, the carries and the
    lazily built tables (a log-polar tap table may leave its cache).  A
    graph reads them by address, so its slot holds them.  (A function mode,
    not a dispatch mode: a process's first dispatch mode imports
    ``torch._dynamo``, about 8 s on the card's host.)"""

    def __init__(self):
        super().__init__()
        self._made: set = set()
        self.read: Dict[int, torch.Tensor] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in pytree.tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                ptr = t.untyped_storage().data_ptr()
                if ptr not in self._made:
                    self.read.setdefault(ptr, t)
        out = func(*args, **kwargs)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._made.add(t.untyped_storage().data_ptr())
        return out


class FrameSlot:
    """One key's static buffers: the frame and the packed parameter vector
    in host memory (pinned on a CUDA device) and on the device, the
    ``summary``'s host vector (allocated at the key's first, eager run),
    and, once captured, the graph, its outputs and the kernel launches a
    replay makes."""

    def __init__(self, device: torch.device, frame: np.ndarray, n_params: int):
        self._pin = device.type == "cuda"
        dtype = torch.from_numpy(np.empty(0, frame.dtype)).dtype
        self.host_frame = torch.empty(frame.shape, dtype=dtype, pin_memory=self._pin)
        self.frame = torch.empty(frame.shape, dtype=dtype, device=device)
        self.host_params = torch.empty((n_params,), dtype=torch.float32, pin_memory=self._pin)
        self.params = torch.empty((n_params,), dtype=torch.float32, device=device)
        self.host_summary: Optional[torch.Tensor] = None
        self.graph = None
        self.outputs = None
        self.launches: Dict[Callable, int] = {}
        #: what the graph reads and did not make, held as long as it
        self.inputs: list = []

    def load(self, frame: np.ndarray, params: np.ndarray) -> None:
        """The host's part of a frame: both inputs into the host buffers."""
        np.copyto(self.host_frame.numpy(), frame)
        np.copyto(self.host_params.numpy(), params)

    def upload(self):
        """The body's first step: ``(frame, params)`` on the device."""
        self.frame.copy_(self.host_frame, non_blocking=True)
        self.params.copy_(self.host_params, non_blocking=True)
        return self.frame, self.params

    def read_back(self, summary: torch.Tensor) -> torch.Tensor:
        """The body's last step: ``summary`` into the host vector, which
        holds it once :meth:`FrameGraphs.wait` returns."""
        if self.host_summary is None:
            self.host_summary = torch.empty(summary.shape, dtype=summary.dtype, pin_memory=self._pin)
        self.host_summary.copy_(summary, non_blocking=True)
        return self.host_summary


class FrameGraphs:
    """A node's frame chains, each captured once as a CUDA graph and
    replayed a frame.

    A key holds every input the captured work depends on besides the
    contents of the static buffers: the chain (method 4 in short range, in
    long range, or methods 3 and 5), the frame's shape, dtype and channels,
    ``cx_eff`` (the crop's column and getRT's principal point), whether
    ``raw_output`` and scale/rotation are on.  The carries are the node's
    static buffers, which every graph reads and then overwrites in place.
    The chain also reads Python values that are in neither the key nor the
    parameter vector: the node's configuration (``scale_factor``,
    ``filter_method`` and its RANSAC sizes, ``backend``, ``use_pallas``,
    ``quantize_8bit``, ``scale_rot_interp``, ``long_range_ratio``, the
    patch and the radii).  They are fixed for a node's life, so a graph is
    right only for the node that captured it: graphs stay per node.

    :meth:`run` runs ``body`` directly on the CPU and where the caller asks
    for no capture (a stream's first frame, whose carry is not set yet).
    Otherwise the key's first frame runs ``body`` eagerly on this runner's
    capture stream (that run builds and loads the kernel libraries and
    makes their lazy tables and merge counters, all outside the capture)
    and then captures it; every later frame replays the graph.  A capture
    that fails raises: the frame fails and nothing falls back to the eager
    chain.

    A graph lives as long as the runner: one per node, never shared, with
    one private memory pool for all its graphs, which never run at once.  It
    is dropped when its capture fails (the key's next frame captures
    again) and, all of them, by :meth:`close`.  ``generators`` are
    registered with every graph, so each replay advances them as the eager
    chain does.  The kernel wrappers count in Python, which a replay does
    not run: the launches counted while capturing are taken back and added
    again at every replay.  Python's garbage collector is paused while a
    graph captures, so that no other node's graphs are destroyed inside the
    capture.
    """

    def __init__(self, device: torch.device, generators: Iterable[torch.Generator] = ()):
        self.device = device
        self._generators = tuple(generators)
        self._slots: Dict[tuple, FrameSlot] = {}
        self._stream = None
        self._pool = None
        #: graphs captured and replayed so far
        self.captures = 0
        self.replays = 0

    def slot(self, key: tuple, frame: np.ndarray, n_params: int) -> FrameSlot:
        """The static buffers of ``key``, made at its first frame."""
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = FrameSlot(self.device, frame, n_params)
        return slot

    def run(self, slot: FrameSlot, body: Callable, capture: bool):
        """One frame of ``slot``'s chain: ``body()``'s outputs, or the
        graph's static ones (valid until the next replay)."""
        if self.device.type != "cuda" or not capture:
            return body()
        if slot.graph is None:
            return self._warm_and_capture(slot, body)
        slot.graph.replay()
        for fn, n in slot.launches.items():
            fn.LAUNCHES += n
        self.replays += 1
        return slot.outputs

    def _warm_and_capture(self, slot: FrameSlot, body: Callable):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = body()  # this frame, eagerly, on the stream the capture runs on
        current.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        before = {fn: fn.LAUNCHES for fn in WRAPPERS}
        read = _InputsRead()
        # the collector stays out of the capture: a dropped node's graphs that
        # it frees there are destroyed mid-capture, which CUDA refuses
        # (cudaGraphExecDestroy while a stream captures), and the capture fails
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream), read:
                outputs = body()
        finally:
            if collecting:
                gc.enable()
            # the capture ran nothing on the device: its counts go to the replays
            launches = {fn: fn.LAUNCHES - n for fn, n in before.items()}
            for fn, n in before.items():
                fn.LAUNCHES = n
        slot.graph, slot.outputs = graph, outputs
        slot.launches = {fn: n for fn, n in launches.items() if n}
        # the kernels' merge counters of this stream reach them as pointers,
        # and a wrapper replaces a buffer that another call outgrows
        stream = self._stream.cuda_stream
        counters = [buf for key, buf in cuda_kernels._COUNTERS.items() if key[2] == stream]
        slot.inputs = list(read.read.values()) + counters
        self.captures += 1
        return out

    def wait(self) -> None:
        """The frame's one host synchronisation: its readback is in host
        memory when this returns."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def close(self) -> None:
        """Drop every graph and static buffer."""
        self._slots.clear()
