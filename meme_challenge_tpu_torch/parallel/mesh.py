"""Device mesh and sharding rules over ``torch.distributed``.

Counterpart of ``meme_challenge_tpu/parallel/mesh.py`` (:25-152). The JAX
package expresses its parallel layer through ``jax.sharding`` and lets XLA
insert the collectives; the port runs one process a device (``torchrun``),
names the mesh with a ``torch.distributed.device_mesh.DeviceMesh`` and
writes the collectives out (``parallel/fold_parallel.py``,
``models/uniter.py: FoldStack``):

- **fold**: the crossval folds are split over the ranks of this axis;
- **data**: each fold's micro-batch is split by rows over this axis;
- **model**: the encoder's products are split Megatron-style over this axis.

A spec is a dict ``{mesh axis: placement}`` (``Shard(d)``: tensor dim ``d``
split over that axis; an axis not named replicates), the counterpart of a
JAX ``PartitionSpec``, which names an axis for each tensor dim.
:func:`placements` turns it into the ``DTensor`` placements of a mesh.

Without a process group the port runs one process on one device:
``make_mesh`` then gives a mesh of one device (all folds on it, as a JAX
mesh whose fold axis has size 1), and a shape that needs more raises.
"""
from __future__ import annotations

import datetime
import math
import os
import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

Spec = Dict[str, object]   # mesh axis name -> Shard(d) | Replicate()

# a rank that dies aborts its group's collectives after this long, instead
# of leaving the other ranks waiting forever
TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(device: str = "cuda",
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout: datetime.timedelta = TIMEOUT) -> None:
    """Start the process group: ``nccl`` for a cuda device, ``gloo`` for the
    CPU. The address, world size and rank come from the environment
    ``torchrun`` sets (``env://``) unless ``init_method`` (for example
    ``file://...``) with ``world_size`` and ``rank`` is given. Collectives
    time out after ``timeout``, so a dead rank aborts the group."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kwargs = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method, world_size=world_size,
                      rank=rank)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, timeout=timeout, **kwargs)


def launched() -> bool:
    """Whether this process was started by ``torchrun`` (or another
    launcher that sets ``WORLD_SIZE`` and ``RANK``)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


@dataclass(frozen=True)
class Mesh:
    """A named device mesh: ``shape`` and its ``axis_names``; with a
    process group, the ``DeviceMesh`` over its ranks (None for the one
    process of a run without one)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device_mesh: Optional[object] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        if axis not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(axis)]

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 without it)."""
        if self.device_mesh is None or axis not in self.axis_names:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank's ``axis`` (None: one member)."""
        if self.device_mesh is None or self.axis_size(axis) == 1:
            return None
        return self.device_mesh.get_group(axis)


def make_mesh(shape: Sequence[int] = (),
              axes: Sequence[str] = ("fold", "data"),
              device: str = "cuda") -> Mesh:
    """A mesh over the run's ranks. An empty ``shape`` puts every rank on
    the first axis, as in the JAX package; a shape whose product differs
    from the world size raises (the JAX ``make_mesh`` asserts the device
    count). Without a process group the run is one process on one device:
    a shape of more than one device raises and names ``torchrun``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not shape:
        shape, axes = (world,), tuple(axes)[:1]
    shape, axes = tuple(int(n) for n in shape), tuple(axes)[:len(shape)]
    if len(axes) != len(shape):
        raise ValueError("mesh shape %s has more axes than the names %s"
                         % (shape, axes))
    if math.prod(shape) != world:
        hint = ("" if dist.is_initialized() else
                "; this process has no process group: start one process a "
                "device with torchrun (torchrun --nproc_per_node %d -m ...)"
                % math.prod(shape))
        raise ValueError("mesh shape %s over axes %s needs %d devices, the "
                         "run has %d%s" % (shape, axes, math.prod(shape),
                                           world, hint))
    if not dist.is_initialized():
        return Mesh(shape, axes)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = torch.device(device).type
    return Mesh(shape, axes, init_device_mesh(device_type, shape,
                                              mesh_dim_names=axes))


def replicated(mesh: Mesh) -> list:
    """The placements of a tensor every rank holds whole."""
    return placements(mesh, {})


def data_sharding(mesh: Mesh, axis: str = "data") -> list:
    """The placements of a batch split by its leading dim over the data
    axis (replicated without one)."""
    return placements(mesh, {axis: Shard(0)})


# Megatron-style split of an encoder layer's nn.Linear ([out, in]) leaves:
# the products whose output features split (column) and those whose input
# features split (row); a column split's bias splits with it, a row split's
# bias and the LayerNorms are replicated
_COLUMN = re.compile(r"\.(attention\.self\.(query|key|value)|intermediate"
                     r"\.dense)\.(weight|bias)$")
_ROW = re.compile(r"\.(attention\.output\.dense|output\.dense)\.weight$")


def encoder_tp_spec(name: str, model_axis: str = "model") -> Spec:
    """Tensor-parallel spec of an encoder layer's parameter, by its torch
    name (JAX ``encoder_tp_spec`` on the port's ``[out, in]`` layout):
    ``query``/``key``/``value``/``intermediate.dense`` weight and bias
    split their output features (``Shard(0)``), ``attention.output.dense``
    and ``output.dense`` weights their input features (``Shard(1)``); the
    rest is replicated."""
    if _COLUMN.search(name):
        return {model_axis: Shard(0)}
    if _ROW.search(name):
        return {model_axis: Shard(1)}
    return {}


def uniter_param_specs(params: Dict[str, torch.Tensor],
                       model_axis: str = "model",
                       fold_axis: Optional[str] = None) -> Dict[str, Spec]:
    """Specs of a MemeUniter state dict (JAX ``uniter_param_specs``): the
    encoder by :func:`encoder_tp_spec`, ``word_embeddings`` split by vocab
    row, ``img_linear.weight`` by output feature, the rest replicated.
    ``fold_axis`` prepends a fold dim split over that axis (fold-stacked
    parameters ``[F, ...]``)."""
    specs = {}
    for name in params:
        if ".encoder." in name:
            spec = encoder_tp_spec(name, model_axis)
        elif name.endswith("word_embeddings.weight"):
            spec = {model_axis: Shard(0)}
        elif name.endswith("img_linear.weight"):
            spec = {model_axis: Shard(0)}
        else:
            spec = {}
        if fold_axis is not None:
            spec = {a: Shard(p.dim + 1) for a, p in spec.items()}
            spec[fold_axis] = Shard(0)
        specs[name] = spec
    return specs


def filter_divisible_specs(mesh: Mesh, params: Dict[str, torch.Tensor],
                           specs: Dict[str, Spec]) -> Dict[str, Spec]:
    """Drop the split of any dim that its mesh axis does not divide evenly
    (JAX ``filter_divisible_specs``): such a leaf (a vocabulary the model
    axis does not divide) is replicated over that axis instead."""
    out = {}
    for name, spec in specs.items():
        shape = params[name].shape
        out[name] = {a: p for a, p in spec.items()
                     if not isinstance(p, Shard)
                     or (p.dim < len(shape)
                         and shape[p.dim] % mesh.axis_size(a) == 0)}
    return out


def placements(mesh: Mesh, spec: Spec) -> list:
    """The ``DTensor`` placements of ``spec``, one a mesh dim."""
    return [spec.get(a, Replicate()) for a in mesh.axis_names]


def apply_shardings(mesh: Mesh, params: Dict[str, torch.Tensor],
                    specs: Dict[str, Spec]) -> Dict[str, object]:
    """Every leaf as a ``DTensor`` with its spec's placements
    (``distribute_tensor``). Every rank passes the same full tensors (made
    from one seed, or read from one file) and keeps its own shards, with no
    communication; ``.to_local()`` gives them."""
    return {name: distribute_tensor(t, mesh.device_mesh,
                                    placements(mesh, specs[name]),
                                    src_data_rank=None)
            for name, t in params.items()}
