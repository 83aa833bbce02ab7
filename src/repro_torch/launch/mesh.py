"""Meshes: port of ``repro.launch.mesh``.

The trainer's meshes (``mesh_shape_for``, ``make_mesh_for``,
``make_production_mesh``) are ``torch.distributed`` ``DeviceMesh``es of
named axes (``pod``, ``data``, ``model``) over the process group, one
process per rank: ``init_device_mesh`` over the ranks of the current
group.  ``mesh_shape_for`` is a copy of the JAX package's pure
factorization, with the same errors.

The distributed-conquer solver's mesh is the other half
(``make_solver_mesh``, :class:`SolverMesh`).

The JAX package's sharded solve is single-controller: one Python caller
runs ``eigvalsh_tridiagonal(d, e, mesh=P)`` and ``shard_map`` maps the
body over P devices of one process.  The port keeps that model: a
:class:`SolverMesh` is an ordered tuple of P torch devices driven from one
process, and the solver's halo and all-gather are tensor copies to each
shard's device (``repro_torch.dist.sharding``), peer copies between two
cards.  A mesh may name one device more than once -- the counterpart of
the JAX package's forced host devices -- which is how the CPU tests run P
shards (``make_solver_mesh(4, devices=["cpu"] * 4)``) and how one card
runs P shards (``devices=["cuda:0"] * 4``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.sharding import SOLVER_AXIS, _extents


@dataclasses.dataclass(frozen=True)
class SolverMesh:
    """``shards`` contiguous problem shards, shard p on ``devices[p]``
    (device strings such as ``"cuda:0"`` or ``"cpu"``).  Frozen and
    hashable, so a mesh can sit in a plan key."""
    shards: int
    devices: tuple


def _normalize_device(device) -> str:
    """A device string with an explicit card index (``"cuda"`` is card
    0); raises for a card that is not visible or a device type the port
    does not run on."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"solver mesh devices are 'cuda:<i>' or 'cpu', "
                         f"got {device!r}")
    index = 0 if dev.index is None else dev.index
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= visible:
        raise ValueError(f"solver mesh names cuda:{index} but only "
                         f"{visible} CUDA device(s) are visible")
    return f"cuda:{index}"


def visible_devices(device_type: str) -> list[str]:
    """The devices of a type that a mesh may take without naming them:
    every visible card for ``"cuda"``, the one host for ``"cpu"``."""
    if device_type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [f"cuda:{i}" for i in range(count)]
    return ["cpu"]


def make_solver_mesh(shards: int, devices=None) -> SolverMesh:
    """1-D mesh for the distributed-conquer eigensolver: ``shards`` shards
    on the first ``shards`` entries of ``devices`` (default: the visible
    cards, one shard each).

    The D&C tree pairs nodes, so the shard count must be a power of two,
    and the devices must be there: a shortfall raises with the spelling
    that runs several shards on one device rather than falling back.
    """
    shards = int(shards)
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if shards & (shards - 1):
        raise ValueError(
            f"shards must be a power of two (the D&C tree pairs nodes), "
            f"got {shards}")
    if devices is None:
        avail = visible_devices("cuda")
        if shards > len(avail):
            raise ValueError(
                f"solver mesh needs {shards} devices but only {len(avail)} "
                f"CUDA device(s) are visible; to run several shards on one "
                f"device name it once per shard, e.g. "
                f"make_solver_mesh({shards}, devices=['cuda:0'] * {shards}) "
                f"or devices=['cpu'] * {shards}")
        devices = avail
    devices = [_normalize_device(d) for d in devices]
    if shards > len(devices):
        raise ValueError(
            f"solver mesh needs {shards} devices but devices=[...] names "
            f"{len(devices)}; repeat a device to run several shards on it, "
            f"e.g. devices=['cuda:0'] * {shards}")
    return SolverMesh(shards, tuple(devices[:shards]))


def describe(mesh) -> str:
    """``"data=32 x model=8"`` for a trainer's ``DeviceMesh`` (or any mesh
    with named extents, as the JAX package's); ``"shard=P on
    <devices>"`` for a :class:`SolverMesh`: the JAX package's
    ``"shard=P"`` and the shards' devices."""
    if isinstance(mesh, SolverMesh):
        return f"{SOLVER_AXIS}={mesh.shards} on {', '.join(mesh.devices)}"
    return " x ".join(f"{k}={v}" for k, v in _extents(mesh).items())


# ---------------------------------------------------------------------------
# The trainer's meshes
# ---------------------------------------------------------------------------

# The production meshes' shapes, derived for the H100 rather than copied
# from the TPU's (16, 16): ``model = 8`` is one host's NVLink domain (a
# DGX H100 holds 8 cards, each with 18 NVLink 4 links at 450 GB/s each
# way through the NVSwitches), so the tensor-parallel collectives never
# leave the host; ``data = 32`` keeps the JAX package's 256 ranks a pod.
PRODUCTION_SHAPE = (32, 8)
PRODUCTION_AXES = ("data", "model")
HOST_CARDS = 8


def mesh_shape_for(devices: int, *, model_parallel: int = 16,
                   pods: int = 1):
    """Pure factorization behind :func:`make_mesh_for` -- returns
    ``(shape, axis_names)`` without touching the process group, so the
    awkward-count behavior is unit-testable on any box.

    Hardened for awkward counts: `model` is the largest divisor of
    `devices` not exceeding `model_parallel` (odd / non-power-of-two
    counts land on a real factorization instead of halving past valid
    divisors or dividing by zero), the pod axis only materializes when
    it divides the remainder, and impossible inputs raise instead of
    deriving a degenerate mesh.
    """
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if model_parallel < 1:
        raise ValueError(
            f"model_parallel must be >= 1, got {model_parallel}")
    if pods < 1:
        raise ValueError(f"pods must be >= 1, got {pods}")
    model = max(m for m in range(1, min(model_parallel, devices) + 1)
                if devices % m == 0)
    rest = devices // model
    pod = pods if pods > 1 and rest % pods == 0 else 1
    data = rest // pod
    if pod > 1:
        return (pod, data, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def _device_mesh(shape, axes, device_type):
    """``init_device_mesh`` over the current process group, whose world
    size must be the mesh's rank count."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    ranks = 1
    for x in shape:
        ranks *= int(x)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {dict(zip(axes, shape))} mesh needs a process group of "
            f"{ranks} ranks: call torch.distributed.init_process_group "
            f"first (torchrun sets its environment)")
    world = dist.get_world_size()
    if world != ranks:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {ranks} "
                         f"ranks but the process group has {world}")
    return init_device_mesh(device_type, tuple(int(x) for x in shape),
                            mesh_dim_names=tuple(axes))


def _default_device_type(device_type):
    return "cuda" if device_type is None else str(device_type)


def make_mesh_for(devices: int, *, model_parallel: int = 16, pods: int = 1,
                  device_type: str | None = None):
    """Elastic variant: the best (pod, data, model) ``DeviceMesh`` for an
    arbitrary rank count (restart-on-fewer-hosts path), over the
    process group (whose world size must be ``devices``), on
    ``device_type`` ranks (None: the card).  See :func:`mesh_shape_for`
    for the factorization rules."""
    shape, axes = mesh_shape_for(devices, model_parallel=model_parallel,
                                 pods=pods)
    return _device_mesh(shape, axes, _default_device_type(device_type))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """(data 32, model 8) single-pod or (pod 2, data 32, model 8) two-pod
    production mesh (:data:`PRODUCTION_SHAPE`: ``model`` is one DGX H100
    host's eight NVLink-joined cards)."""
    shape = ((2,) + PRODUCTION_SHAPE) if multi_pod else PRODUCTION_SHAPE
    axes = (("pod",) + PRODUCTION_AXES) if multi_pod else PRODUCTION_AXES
    return _device_mesh(shape, axes, _default_device_type(device_type))
