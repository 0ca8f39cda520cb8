"""Batch sharding over a device mesh (port of
:mod:`mrs_optic_flow_tpu.parallel.sharding`).

Frame pairs are independent, so a batch splits along its leading axis over a
1-D ``data`` mesh and every shard runs the same launches on its own device;
only the results and the fleet statistic are brought together, on the
mesh's first device.  PyTorch has no ``jax.sharding.Mesh``: :class:`Mesh` is
the port's, a tuple of devices.  A mesh may hold several cards, or several
shards of one device (``make_mesh(4, device="cuda:0")``, the counterpart of
the JAX tests' virtual host devices), which runs the same split and gather.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class Mesh:
    """A 1-D mesh: ``devices`` is a numpy object array ``[n]`` of
    ``torch.device`` (``mesh.devices.shape == (n,)`` as for a JAX mesh),
    one entry a shard; ``axis_names`` names its one axis."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...] = ("data",)):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devices), dtype=object)
        for i, d in enumerate(devices):
            self.devices[i] = torch.device(d)
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.shape[0])

    @property
    def first(self) -> torch.device:
        """Where results are gathered."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names})"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data", *,
              device=DEFAULT_DEVICE) -> Mesh:
    """1-D mesh.  A bare ``"cuda"`` takes the first ``n_devices`` cards (all
    of them by default) and raises if the host has fewer; it never falls
    back to the CPU.  A device that names one place (``"cuda:0"``,
    ``"cpu"``) gets ``n_devices`` shards (1 by default) on that device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else int(n_devices)
        if n < 1 or have < n:
            raise RuntimeError(f"make_mesh({n_devices}) on 'cuda': the host has {have} CUDA "
                               "device(s); pass device='cpu' or 'cuda:0' for shards of one device")
        return Mesh([torch.device("cuda", i) for i in range(n)], (axis_name,))
    dev = resolve_device(dev)
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be at least 1, got {n}")
    return Mesh([dev] * n, (axis_name,))


class Sharded:
    """A batch split along its leading axis over a mesh: ``shards[i]`` lies
    on ``mesh.devices[i]``."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: Mesh):
        self.shards = tuple(shards)
        self.mesh = mesh

    @property
    def shape(self) -> torch.Size:
        return torch.Size((sum(s.shape[0] for s in self.shards),) + tuple(self.shards[0].shape[1:]))

    def gather(self) -> torch.Tensor:
        """The whole batch on the mesh's first device."""
        return gather(self.shards, self.mesh)


def scatter(x, mesh: Mesh, dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """``x`` ``[B, ...]`` (a tensor, an array or a :class:`Sharded` of this
    mesh) as one part a shard, each on its device.  B must divide evenly,
    as under JAX's ``P("data")``.  ``dtype`` casts each part."""
    if isinstance(x, Sharded):
        if x.mesh is not mesh and list(x.mesh.devices) != list(mesh.devices):
            raise ValueError(f"a batch sharded over {x.mesh} given to {mesh}")
        parts = list(x.shards)
    else:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        b, n = x.shape[0], mesh.size
        if b % n:
            raise ValueError(f"a batch of {b} does not split evenly over a mesh of {n}")
        k = b // n
        parts = [x[i * k:(i + 1) * k] for i in range(n)]
    return [p.to(device=d, dtype=dtype) for p, d in zip(parts, mesh.devices)]


def gather(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """One part a shard, concatenated on the mesh's first device (one part
    is returned as it is, on that device)."""
    if len(parts) == 1:
        return parts[0].to(mesh.first)
    return torch.cat([p.to(mesh.first) for p in parts])


def shard_batch(x, mesh: Mesh, axis_name: str = "data") -> Sharded:
    """``x`` ``[B, ...]`` split evenly along its leading axis over ``mesh``,
    each part on its device; raises where B does not divide."""
    return Sharded(scatter(x, mesh), mesh)


def sharded_flow_step(engine, mesh: Mesh, axis_name: str = "data"):
    """Batch-sharded throughput step: ``fn(prev [B, H, W], curr [B, H, W])
    -> (shifts [B, P, 2], fleet_mean_speed [])``, both on the mesh's first
    device.  Each shard runs ``engine.step_batch`` on its device (kernel A
    once a shard on the card); ``fleet_mean_speed`` is the mean
    ``|shifts_raw|`` over every shard, NaN if any is NaN, as the JAX
    ``jnp.mean`` under ``psum``.  Inputs may be plain or
    :func:`shard_batch`-ed."""

    def step(prev, curr):
        shifts, speeds = [], []
        for p, c in zip(scatter(prev, mesh), scatter(curr, mesh)):
            res = engine.step_batch(p, c)
            shifts.append(res.shifts)
            speeds.append(torch.linalg.norm(res.shifts_raw, dim=-1))
        return gather(shifts, mesh), torch.mean(gather(speeds, mesh))

    return step
