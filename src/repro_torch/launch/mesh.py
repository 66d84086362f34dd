"""Production mesh shapes, as the JAX package's ``launch/mesh.py``.

Single pod: (data=16, model=16) = 256 chips. Multi-pod: ("pod", "data",
"model") = (2, 16, 16) = 512 chips; the "pod" axis carries pure data
parallelism (gradient all-reduce crosses the inter-pod links once per
step).

The port places nothing on a mesh: a mesh here is its named axis sizes
(:class:`MeshShape`), which is all the sharding rules and the accounting
read (``sharding/rules.py``, ``launch/dryrun_lib.py``). No device is
touched.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MeshShape:
    """A mesh as named axis sizes: ``axis_names`` and ``shape[axis]``,
    as a ``jax.sharding.Mesh`` gives them."""
    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes) -> MeshShape:
    """Arbitrary mesh for tests (e.g. (2,2,2) px/py/pz Faces)."""
    return MeshShape(tuple(axes), tuple(int(s) for s in shape))
