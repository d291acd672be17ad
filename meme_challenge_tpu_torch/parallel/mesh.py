"""The device mesh of the port: one card.

Counterpart of ``make_mesh`` in ``meme_challenge_tpu/parallel/mesh.py``
(:41-57) for the one-device case. A mesh's shape multiplies out to the
number of devices the run uses, which for the port is one: ``--mesh_shape 1
--mesh_axes fold`` puts all F folds on that card, as a JAX mesh whose fold
axis has size 1 holds every fold on its one device. A ``data`` or ``model``
axis above 1, or any shape that needs more than one device, raises:
multi-device parallelism is the last item of ROADMAP.md's Queue 1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

DEVICES = 1  # the port runs on one card


@dataclass(frozen=True)
class Mesh:
    """A named device mesh: ``shape`` and its ``axis_names``."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_mesh(shape: Sequence[int] = (),
              axes: Sequence[str] = ("fold", "data")) -> Mesh:
    """A mesh over the run's one device. An empty ``shape`` puts that device
    on the first axis, as in the JAX package."""
    if not shape:
        shape, axes = (DEVICES,), tuple(axes)[:1]
    shape, axes = tuple(int(n) for n in shape), tuple(axes)[:len(shape)]
    if len(axes) != len(shape):
        raise ValueError("mesh shape %s has more axes than the names %s"
                         % (shape, axes))
    wide = [a for a, n in zip(axes, shape) if n > 1]
    if math.prod(shape) != DEVICES or wide:
        raise ValueError(
            "mesh shape %s over axes %s needs %d devices; the port runs on "
            "one card (all folds on it: --mesh_shape 1 --mesh_axes fold). "
            "Multi-device parallelism is the last item of ROADMAP.md's "
            "Queue 1." % (shape, axes, math.prod(shape)))
    return Mesh(shape, axes)
