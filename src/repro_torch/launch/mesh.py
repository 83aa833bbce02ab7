"""The distributed-conquer solver's mesh: port of the solver half of
``repro.launch.mesh`` (``make_solver_mesh``, ``describe``).

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

The trainer's meshes (``make_mesh_for``, ``mesh_shape_for``,
``make_production_mesh``) are ROADMAP Queue 1 item 4's other half.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.sharding import SOLVER_AXIS


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


def describe(mesh: SolverMesh) -> str:
    """``"shard=P on <devices>"``: the JAX package's ``"shard=P"`` and the
    shards' devices."""
    return f"{SOLVER_AXIS}={mesh.shards} on {', '.join(mesh.devices)}"
