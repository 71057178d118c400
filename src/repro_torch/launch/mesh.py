"""Device meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``).

A :class:`Mesh` wraps a ``torch.distributed.device_mesh.DeviceMesh`` whose
dims carry the reference's axis names, ``("data", "model")`` or ``("pod",
"data", "model")``, and reads like the reference's ``jax.sharding.Mesh``:
``axis_names``, ``shape`` (a dict of axis sizes), ``size`` (ranks in all).
It adds what the per-rank code needs in place of ``shard_map``: the rank's
coordinate over one axis or a tuple of axes in the mesh's order
(:meth:`Mesh.coord`, the first axis major, as ``decode.py``'s linear slot
rank) and the process group over them (:meth:`Mesh.group`), whose ranks
are in that order.  :class:`MeshShape` is the shape-only
stand-in (``jax.sharding.AbstractMesh``'s counterpart) that the placement
rules of :mod:`repro_torch.dist.sharding` also take.

Nothing here initialises a process group: the caller does, with the
``"nccl"`` backend for CUDA and ``"gloo"`` for the CPU (:func:`backend_for`),
before it builds a mesh.  A world of one rank needs no address:
``init_process_group(backend, store=HashStore(), rank=0, world_size=1)``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

DP_AXES = ("pod", "data")


def backend_for(device_type: str) -> str:
    """The process group backend of a device type."""
    return "nccl" if device_type == "cuda" else "gloo"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without ranks or devices: what the
    placement rules read (``AbstractMesh``'s counterpart)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


class Mesh:
    """A ``DeviceMesh`` (or a named slice of one) with the reference mesh's
    reading API, the rank's coordinates and the process groups of its axes.
    Groups over a tuple of axes are made once, by the member ranks alone."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.size = device_mesh.mesh.numel()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if device_mesh.device_type == "cuda" else torch.device("cpu"))
        self._groups = {}

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [self.axis_names.index(a) for a in axes]
        if pos != sorted(pos):
            # a process group orders its ranks by global rank, which is the
            # coordinate's order only for axes in the mesh's order
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def coord(self, axes) -> int:
        """The rank's linear coordinate over ``axes``, the first axis major."""
        rank = 0
        for a in self._axes(axes):
            rank = rank * self.shape[a] + self.device_mesh.get_local_rank(a)
        return rank

    def group(self, axes):
        """The process group of the ranks that share this rank's coordinates
        on every axis outside ``axes``, ordered by :meth:`coord`."""
        axes = self._axes(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            pos = [self.axis_names.index(a) for a in axes]
            here = list(self.device_mesh.get_coordinate())
            ranks = []
            for lin in range(self.axis_size(axes)):
                c = list(here)
                for p, a in zip(reversed(pos), reversed(axes)):
                    lin, c[p] = divmod(lin, self.shape[a])
                ranks.append(int(self.device_mesh.mesh[tuple(c)]))
            self._groups[axes] = dist.new_group(ranks, use_local_synchronization=True)
        return self._groups[axes]


def axis_size(mesh, axes) -> int:
    """Ranks over ``axes`` (None: 1; an axis name; a tuple of names)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def make_mesh(shape, axes, device_type: str | None = None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the whole world (the process
    group must exist; its backend picks the device type by default)."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes)))


def make_host_mesh(model: int = 1, device_type: str | None = None) -> Mesh:
    """``("data", "model")`` over however many ranks the world has."""
    n = dist.get_world_size()
    return make_mesh((n // model, model), ("data", "model"), device_type)


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh: 16 x 16, or 2 x 16 x 16 pods."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> Mesh:
    """The production mesh over a world of 256 (512) ranks."""
    s = production_shape(multi_pod=multi_pod)
    return make_mesh(s.sizes, s.axis_names, device_type)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in DP_AXES)


def chips(mesh) -> int:
    return math.prod(mesh.shape.values())
