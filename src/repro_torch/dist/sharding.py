"""Sharding rules for the (pod, data, model) meshes and the solver
tree's collectives: port of ``repro.dist.sharding``.

**The trainer's rules.**  Parameters carry *logical* axis names derived
from their leaf name in the parameter tree (``models/layers.py``
documents the layout, e.g. wq: (d_model, heads, head_dim)).
``logical_param_specs`` maps those logical axes onto mesh axes:

    d_model-like dims  -> "data"   (FSDP: parameters sharded over the DP axis)
    heads / ffn / V    -> "model"  (tensor parallel)

and returns, per leaf, the JAX package's ``PartitionSpec`` as a tuple (an
axis name, a tuple of names, or None per dimension; ``()`` for a leaf no
rule names).  Any dim whose size does not divide the mesh-axis extent is
*pruned* to replicated (``_prune``) -- sharding is a best-effort layout
hint, never a correctness requirement.  :func:`placements` turns a spec
into ``DTensor`` placements on a ``DeviceMesh`` (a dimension named by
several mesh axes is ``Shard(i)`` on each, major to minor, as JAX lays it
out), ``param_shardings`` gives the tree of :class:`Sharding`, and
``distribute_tree`` is the port's ``jax.device_put(tree, shardings)``.

The JAX package's trainer is single-controller GSPMD (``jax.jit`` with
``in_shardings``; XLA inserts the collectives).  The port runs one
process per rank: parameters are ``DTensor``s, the model functions run
unchanged on them, and DTensor's sharding propagation inserts the
collectives.

Activation constraints (``constrain_batch_acts``,
``constrain_seq_model_acts``) are switches: they return the tensor
untouched until ``set_activation_mesh`` installs a mesh (and for a tensor
that is not a ``DTensor``), so smoke tests and one-device runs execute the
exact same model code.  On a ``DTensor`` they ``redistribute`` to the
spec's placements on the tensor's own mesh.  Inside a region where some
axes are Manual (the compressed step's pod-local loss, the pipeline's
stages), constraints must not mention those axes -- ``set_manual_axes`` is
the flag ``launch/steps.py`` and ``launch/pipeline.py`` flip around them.

**The solver tree's collectives** (``halo_from_left``, ``gather_lanes``,
``gather_tree_state``) are described below, with them.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, NamedTuple, Optional

import torch

from repro_torch.dist import compression as _comp



def _extents(mesh) -> dict:
    """``{axis name: extent}`` of a ``DeviceMesh`` (``mesh_dim_names``
    beside ``mesh.shape``) or of any object whose ``shape`` is already
    such a mapping (the JAX package's ``Mesh``, a test's stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(x) for x in mesh.shape)))
    return {k: int(v) for k, v in dict(mesh.shape).items()}


# ---------------------------------------------------------------------------
# Activation state
# ---------------------------------------------------------------------------

_ACTIVATION_MESH: Optional[Any] = None
_SEQUENCE_PARALLEL: bool = False
_MANUAL_AXES: frozenset = frozenset()


def set_activation_mesh(mesh) -> None:
    """Install (or clear, with None) the mesh used by activation
    constraints and the MoE dispatch groups."""
    global _ACTIVATION_MESH
    _ACTIVATION_MESH = mesh


def get_activation_mesh():
    return _ACTIVATION_MESH


def set_sequence_parallel(enabled: bool) -> None:
    """Megatron-style sequence parallelism: the residual stream's seq dim is
    sharded over 'model' between blocks (variant "sp" in dryrun)."""
    global _SEQUENCE_PARALLEL
    _SEQUENCE_PARALLEL = bool(enabled)


def set_manual_axes(axes: Iterable[str]) -> None:
    """Mesh axes currently Manual (each rank holds its own slice and the
    code maps over them by hand): constraints and dispatch groups must not
    use them."""
    global _MANUAL_AXES
    _MANUAL_AXES = frozenset(axes)


def model_axis_extent() -> int:
    """Extent of the tensor-parallel axis in the activation mesh (1 if unset)."""
    mesh = _ACTIVATION_MESH
    if mesh is None or "model" in _MANUAL_AXES:
        return 1
    return int(_extents(mesh).get("model", 1))


def dp_axis_extent() -> int:
    """Product of the data-parallel-like extents ('pod' * 'data') visible
    here (Manual axes excluded).  1 on a single device."""
    mesh = _ACTIVATION_MESH
    if mesh is None:
        return 1
    shape = _extents(mesh)
    ext = 1
    for ax in ("pod", "data"):
        if ax in shape and ax not in _MANUAL_AXES:
            ext *= int(shape[ax])
    return ext


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------

def _extent(mesh, axis) -> int:
    """Mesh extent of a spec entry (a name or a tuple of names)."""
    names = axis if isinstance(axis, tuple) else (axis,)
    shape = _extents(mesh)
    return math.prod(int(shape[a]) for a in names)


def _prune(axes, shape, mesh):
    """Drop (replace with None) any sharded dim whose size does not divide
    the mesh extent, or whose axis is absent from the mesh."""
    present = _extents(mesh)
    out = []
    for ax, dim in zip(axes, shape):
        if ax is None:
            out.append(None)
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        if any(a not in present for a in names):
            out.append(None)
            continue
        out.append(ax if dim % _extent(mesh, ax) == 0 else None)
    return tuple(out)


# Trailing-dims rule per leaf name (layers.py layout convention).  Leaves
# may carry extra *leading* dims (the stacked layer axis, MoE expert axis);
# those replicate.  Unknown names replicate entirely.
_NAME_RULES = {
    # token embedding (V, D) / LM head (D, V)
    "embed": ("model", "data"),
    "head": ("data", "model"),
    # attention projections (d_model, heads, head_dim) / (H, hd, d_model)
    "wq": ("data", "model", None),
    "wk": ("data", "model", None),
    "wv": ("data", "model", None),
    "wo": ("model", None, "data"),
    # MLA low-rank factors
    "wq_a": ("data", "model"),
    "wq_b": ("data", "model", None),
    "wkv_a": ("data", "model"),
    "wk_b": ("data", "model", None),
    "wv_b": ("data", "model", None),
    # dense / MoE MLP (d, f) and (f, d); MoE adds a leading expert dim
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    # mamba2 projections (d, proj) / (dn, d)
    "w_in": ("data", "model"),
    "w_out": ("model", "data"),
}


def _leaf_name(path) -> str:
    """The last string key of a tree path (a tuple of dict keys and
    sequence indices), as the JAX package reads its key paths."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree (dicts keep their key order); None
    is no leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec_leaf(tree):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _is_spec_leaf(x) -> bool:
    return isinstance(x, Sharding)


def _param_spec(path, leaf, mesh) -> tuple:
    rule = _NAME_RULES.get(_leaf_name(path))
    shape = tuple(leaf.shape)
    if rule is None or len(shape) < len(rule):
        return ()
    axes = (None,) * (len(shape) - len(rule)) + tuple(rule)
    return _prune(axes, shape, mesh)


def logical_param_specs(params, mesh):
    """Spec-tuple tree for a parameter tree (tensors, meta tensors or
    anything with ``.shape``): the JAX package's ``PartitionSpec`` per
    leaf, as a tuple."""
    return _map_with_path(lambda path, leaf: _param_spec(path, leaf, mesh),
                          params)


def placements(spec, mesh) -> tuple:
    """``DTensor`` placements of a spec tuple on a ``DeviceMesh``: each
    mesh axis that the spec names for tensor dim i is ``Shard(i)`` (a
    dim named by several axes is sharded over each, major to minor as
    the mesh orders them, which is JAX's layout), every other axis
    ``Replicate()``.  Axes the mesh lacks are ignored."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a in names:
                out[names.index(a)] = Shard(i)
    return tuple(out)


class Sharding(NamedTuple):
    """Where a leaf lives: a ``DeviceMesh`` and its placements there (the
    port's ``NamedSharding``), with the spec it came from."""
    mesh: Any
    placements: tuple
    spec: tuple = ()


def sharding(mesh, spec) -> Sharding:
    spec = tuple(spec)
    return Sharding(mesh, placements(spec, mesh), spec)


def param_shardings(params, mesh):
    """:class:`Sharding` tree matching ``logical_param_specs``."""
    return _map_with_path(
        lambda path, leaf: sharding(mesh, _param_spec(path, leaf, mesh)),
        params)


def opt_shardings(opt_state, params, p_sh, mesh):
    """Optimizer-state shardings: a leaf whose shape equals a parameter's
    takes that parameter's sharding (adam's m and v; the first parameter
    of the shape wins, as in the JAX package's dry run); factored
    statistics and scalars replicate."""
    shape_to_sh = {}
    for path_leaf, sh in zip(_leaves_with_paths(params),
                             _leaves_with_paths(p_sh)):
        shape_to_sh.setdefault(tuple(path_leaf[1].shape), sh[1])
    rep = sharding(mesh, ())
    return _map_with_path(
        lambda _, leaf: shape_to_sh.get(tuple(leaf.shape), rep), opt_state)


def _leaves_with_paths(tree):
    out = []
    _map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def distribute_tree(tree, shardings):
    """The port's ``jax.device_put(tree, shardings)``: every leaf of
    ``tree`` (a tensor holding the whole logical array, the same on every
    rank, or a meta tensor) as a ``DTensor`` with its :class:`Sharding`'s
    placements.  Each rank keeps its own shard only, cut from its own
    copy: nothing is sent (``src_data_rank=None``)."""
    flat = iter(_leaves_with_paths(shardings))
    return _map_with_path(lambda _, leaf: distribute_leaf(leaf, next(flat)[1]),
                          tree)


def distribute_leaf(leaf, sh: Sharding):
    """One leaf of :func:`distribute_tree`."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    out = distribute_tensor(leaf, sh.mesh, list(sh.placements),
                            src_data_rank=None)
    local = out.to_local()
    if (local.device.type != "meta" and local.untyped_storage().nbytes()
            > local.numel() * local.element_size()):
        # A shard cut along dim 0 is a view of the whole array; a copy
        # lets the whole one go.
        out = DTensor.from_local(local.clone(), sh.mesh, list(sh.placements),
                                 run_check=False, shape=out.shape,
                                 stride=out.stride())
    return out


def gather_params(tree):
    """A layer's parameters ready for compute: each ``DTensor`` leaf
    gathered over the data-parallel axes ('pod', 'data': the rules' FSDP
    sharding), its tensor-parallel ('model') sharding kept; plain leaves
    untouched.  The gradient goes back through the gather's backward, a
    reduce-scatter onto the leaf's own placements.  Called inside each
    block (under remat the gather is redone in the backward pass), so a
    rank holds one layer's gathered weights at a time -- the FSDP
    schedule; left to itself DTensor may instead contract over the
    sharded dim and all-reduce the (larger) activation."""
    from torch.distributed.tensor import Replicate

    def gather(x):
        if not _is_dtensor(x):
            return x
        names = x.device_mesh.mesh_dim_names
        target = [Replicate() if n in ("pod", "data") and n not in
                  _MANUAL_AXES else pl for n, pl in zip(names, x.placements)]
        if tuple(target) == tuple(x.placements):
            return x
        return x.redistribute(x.device_mesh, target)

    return _map_with_path(lambda _, x: gather(x), tree)


def _dp_axes(mesh, size: int):
    """Best data-parallel spec entry for a dim of `size`: ('pod','data'),
    'data', or None -- largest divisible combination wins."""
    shape = _extents(mesh)
    cands = []
    if "pod" in shape and "data" in shape:
        cands.append(("pod", "data"))
    if "data" in shape:
        cands.append("data")
    if "pod" in shape:
        cands.append("pod")
    for c in cands:
        if size % _extent(mesh, c) == 0 and _extent(mesh, c) > 1:
            return c
    return None


def batch_sharding(mesh, global_batch: int, ndim: int = 2) -> Sharding:
    """Batch-first sharding for input/token arrays: dim 0 over the DP axes
    (when divisible), everything else replicated."""
    spec = [None] * ndim
    if ndim:
        spec[0] = _dp_axes(mesh, global_batch)
    return sharding(mesh, spec)


def cache_specs(cache, cfg, mesh, batch: int):
    """KV / SSM-state cache specs: the batch dim (first dim of size
    `batch`, searching from the left) goes over the DP axes; a kv-heads dim
    (== cfg.num_kv_heads, right of batch) goes over 'model'.  Leaves with
    no recognizable batch dim replicate."""
    return _map_with_path(
        lambda _, leaf: _cache_spec(leaf, cfg, mesh, batch), cache)


def _cache_spec(leaf, cfg, mesh, batch: int) -> tuple:
    kv_heads = getattr(cfg, "num_kv_heads", 0)
    shape = _extents(mesh)
    spec = [None] * len(leaf.shape)
    b_at = None
    for i, dim in enumerate(leaf.shape):
        if dim == batch and i <= 1:
            b_at = i
            spec[i] = _dp_axes(mesh, batch)
            break
    if b_at is not None and kv_heads and "model" in shape:
        for i in range(b_at + 1, len(leaf.shape)):
            if leaf.shape[i] == kv_heads and \
                    kv_heads % _extent(mesh, "model") == 0 and \
                    _extent(mesh, "model") > 1:
                spec[i] = "model"
                break
    return tuple(spec)


def cache_shardings(cache, cfg, mesh, batch: int):
    """:class:`Sharding` tree of :func:`cache_specs`."""
    return _map_with_path(
        lambda _, leaf: sharding(mesh, _cache_spec(leaf, cfg, mesh, batch)),
        cache)


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------

def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _constrain(x, spec):
    """Redistribute a ``DTensor`` activation to ``spec``'s placements on
    its own mesh; anything else (and anything with no mesh installed)
    comes back untouched."""
    if _ACTIVATION_MESH is None or not _is_dtensor(x):
        return x
    target = placements(spec, x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, list(target))


def _visible_dp_axes(mesh, size: int):
    shape = _extents(mesh)
    names = tuple(a for a in ("pod", "data")
                  if a in shape and a not in _MANUAL_AXES)
    while names and size % _extent(mesh, names):
        names = names[1:]
    if not names or _extent(mesh, names) == 1:
        return None
    return names if len(names) > 1 else names[0]


def constrain_batch_acts(x):
    """Pin an activation's batch dim to the visible data-parallel axes.
    With sequence parallelism on, 3-D+ activations also pin seq->'model'."""
    mesh = _ACTIVATION_MESH
    if mesh is None:
        return x
    if _SEQUENCE_PARALLEL and x.ndim >= 3:
        return constrain_seq_model_acts(x)
    spec = [None] * x.ndim
    spec[0] = _visible_dp_axes(mesh, x.shape[0])
    return _constrain(x, spec)


def constrain_gathered_acts(x):
    """(B, S, ...) activations entering a matmul: batch over the visible
    DP axes, the sequence whole -- Megatron's all-gather of a
    sequence-parallel residual stream before the block's projections.
    (Left sharded, DTensor's strategy search for the projections over a
    sequence-sharded operand on a three-axis mesh takes minutes an op.)"""
    mesh = _ACTIVATION_MESH
    if mesh is None:
        return x
    spec = [None] * x.ndim
    spec[0] = _visible_dp_axes(mesh, x.shape[0])
    return _constrain(x, spec)


def constrain_seq_model_acts(x):
    """(B, S, ...) activations: batch over DP axes, seq over 'model' --
    used when heads don't divide the TP extent (and for sequence-parallel
    residual streams)."""
    mesh = _ACTIVATION_MESH
    if mesh is None:
        return x
    shape = _extents(mesh)
    spec = [None] * x.ndim
    spec[0] = _visible_dp_axes(mesh, x.shape[0])
    if x.ndim >= 2 and "model" in shape and "model" not in _MANUAL_AXES \
            and x.shape[1] % _extent(mesh, "model") == 0:
        spec[1] = "model"
    return _constrain(x, spec)


# ---------------------------------------------------------------------------
# Solver-tree collectives (distributed conquer, core/br_dc.py)
# ---------------------------------------------------------------------------
#
# The eigensolver's 1-D mesh (``launch.mesh.SolverMesh``) has one axis,
# SOLVER_AXIS; shard p owns one contiguous slice of the padded tridiagonal
# and lives on the mesh's device p.  The JAX package runs these inside a
# ``shard_map`` body as ``ppermute`` and ``all_gather``; the port drives
# every shard from one process, so a collective takes the per-shard list of
# tensors (each on its shard's device) and returns a per-shard list: the
# transfers are tensor copies to each shard's device (peer copies between
# two cards, none where the devices coincide).  A gathered value is
# computed once per distinct device, and shards that share a device share
# that tensor.  Because the conquer phase carries only O(n) state
# (eigenvalues and r boundary rows), every transfer is linear in the
# slice: a one-element halo in the divide step, one all-gather of the
# per-shard (lam, rows) state at the subtree->cooperative transition, and
# the root windows of the cooperative levels
# (``core.merge.merge_level_coop``).

SOLVER_AXIS = "shard"


def per_device(devices, make):
    """``[make(p) for p in range(len(devices))]``, calling ``make`` once
    per distinct device (with ``p`` the first shard on it): shards that
    share a device share its result."""
    first = {}
    for p, dev in enumerate(devices):
        first.setdefault(str(dev), p)
    memo = {key: make(p) for key, p in first.items()}
    return [memo[str(dev)] for dev in devices]


def halo_from_left(xs):
    """Shift per-shard values one shard to the right: shard p receives
    shard p-1's value on its own device and shard 0 receives zeros (the
    global problem has no boundary left of shard 0), as the JAX package's
    ``ppermute`` fills it."""
    return [torch.zeros_like(xs[0])] + [
        xs[p - 1].to(xs[p].device) for p in range(1, len(xs))]


def gather_lanes(xs):
    """All-gather per-shard trailing lanes into global order: (B, k) on
    each shard -> (B, P * k) on every shard's device, shard p's lanes in
    columns [p*k, (p+1)*k) -- the global node order of the D&C tree."""
    devices = [x.device for x in xs]
    return per_device(devices, lambda p: torch.cat(
        [x.to(devices[p]) for x in xs], dim=1))


def gather_tree_state(lam_locs, rows_locs, *, compress: bool = False):
    """Gather the O(n) subtree state into the replicated node-major layout.

    lam_locs[p]: (B, Np); rows_locs[p]: (B, r, Np) -- shard p's subtree
    root.  Returns per-shard lists of (lam (B, P, Np), rows (B, P, r,
    Np)), the node axis in shard order.

    With ``compress=True`` the rows travel as an int8 payload and one
    float32 scale per (problem, slot) lane (``compression.quantize_lanes``,
    quantized on the sending shard's device) and come back in the rows'
    dtype; the eigenvalues always travel at full precision -- they seed
    the secular poles, where a quantization step would move every root.
    """
    devices = [x.device for x in lam_locs]
    dtype = rows_locs[0].dtype
    lam_g = per_device(devices, lambda p: torch.stack(
        [x.to(devices[p]) for x in lam_locs], dim=1))
    if compress:
        sent = [_comp.quantize_lanes(x) for x in rows_locs]
        rows_g = per_device(devices, lambda p: torch.stack(
            [_comp.dequantize_lanes(q.to(devices[p]), s.to(devices[p]),
                                    dtype) for q, s in sent], dim=1))
    else:
        rows_g = per_device(devices, lambda p: torch.stack(
            [x.to(devices[p]) for x in rows_locs], dim=1))
    return lam_g, rows_g
