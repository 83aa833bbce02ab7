"""DTensor's collectives staged through host memory, for ranks that share
one card.

Ranks that share a card cannot use NCCL (it refuses two ranks on one
device), and over gloo ``DTensor``'s functional collectives
(``torch.ops._c10d_functional``) on CUDA tensors end the process (a
segmentation fault in the all-gather, PyTorch 2.11 on the H100; gloo's
plain ``torch.distributed`` collectives on CUDA tensors do work).
:func:`install` replaces those ops' CUDA kernels in this process with
:func:`staged_collective`: the operand is copied to host memory, the same
collective runs over the group's gloo backend on the CPU copy, and the
result is copied back to the card -- one device-to-host and one
host-to-device copy beside gloo's own transfer.  The model's compute
stays on the card.  Every call is counted with the bytes it staged
(:func:`staged_counts`), so a run can print what the transport carried.

Only a process whose ranks share a card over gloo installs it (the
multi-rank trainer with ``--backend gloo`` on the card, ``chip_smoke.py``
phase 12); NCCL runs never do.  A failed collective raises: nothing falls
back.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

_OPS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
        "all_reduce_", "all_to_all_single", "broadcast", "broadcast_",
        "all_gather_into_tensor_coalesced",
        "reduce_scatter_tensor_coalesced", "all_reduce_coalesced")

_STAGED: dict = {}
_LOCK = threading.Lock()
_LIBS: dict = {}


def staged_counts() -> dict:
    """``{collective: (calls, bytes staged to the host)}`` since the last
    reset."""
    with _LOCK:
        return dict(_STAGED)


def reset_staged_counts() -> None:
    with _LOCK:
        _STAGED.clear()


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _reduce(host, reduce_op: str, group):
    """In-place reduction of a host tensor over ``group`` (gloo has no
    average: a sum divided by the group size)."""
    op = reduce_op.lower()
    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
           "product": dist.ReduceOp.PRODUCT}
    dist.all_reduce(host, op=ops[op], group=group)
    if op == "avg":
        host.div_(dist.get_world_size(group))
    return host


def staged_collective(kind: str, x, group_name, *, reduce_op="sum",
                      group_size=None, src=0, out_splits=None,
                      in_splits=None):
    """One functional collective of ``kind`` on ``x`` (a CUDA tensor) over
    the named group, run on a host copy: returns a new tensor on ``x``'s
    device.  The reduce-scatter is an all-reduce of the host copy and
    this rank's slice of it."""
    group = _group(group_name)
    host = x.detach().to("cpu", copy=True).contiguous()
    with _LOCK:
        calls, nbytes = _STAGED.get(kind, (0, 0))
        _STAGED[kind] = (calls + 1, nbytes + host.numel() * host.element_size())
    if kind == "all_gather":
        n = dist.get_world_size(group)
        out = torch.empty((n * host.shape[0],) + tuple(host.shape[1:]),
                          dtype=host.dtype)
        dist.all_gather_into_tensor(out, host, group=group)
    elif kind == "all_reduce":
        out = _reduce(host, reduce_op, group)
    elif kind == "reduce_scatter":
        n = dist.get_world_size(group)
        rank = dist.get_rank(group)
        full = _reduce(host, reduce_op, group)
        out = full.chunk(n)[rank].contiguous()
    elif kind == "broadcast":
        dist.broadcast(host, src=dist.get_global_rank(group, src),
                       group=group)
        out = host
    elif kind == "all_to_all":
        outs = list(out_splits) if out_splits else None
        rows = sum(outs) if outs else host.shape[0]
        out = torch.empty((rows,) + tuple(host.shape[1:]), dtype=host.dtype)
        dist.all_to_all_single(out, host, outs,
                               list(in_splits) if in_splits else None,
                               group=group)
    else:
        raise ValueError(f"no staged collective {kind!r}")
    return out.to(x.device)


def _all_gather_into_tensor(x, group_size, group_name):
    return staged_collective("all_gather", x, group_name,
                             group_size=group_size)


def _reduce_scatter_tensor(x, reduce_op, group_size, group_name):
    return staged_collective("reduce_scatter", x, group_name,
                             reduce_op=reduce_op, group_size=group_size)


def _all_reduce(x, reduce_op, group_name):
    return staged_collective("all_reduce", x, group_name,
                             reduce_op=reduce_op)


def _all_reduce_(x, reduce_op, group_name):
    return x.copy_(_all_reduce(x, reduce_op, group_name))


def _all_to_all_single(x, output_split_sizes, input_split_sizes,
                       group_name):
    return staged_collective("all_to_all", x, group_name,
                             out_splits=output_split_sizes,
                             in_splits=input_split_sizes)


def _broadcast(x, src, group_name):
    return staged_collective("broadcast", x, group_name, src=src)


def _broadcast_(x, src, group_name):
    return x.copy_(_broadcast(x, src, group_name))


def _all_gather_coalesced(inputs, group_size, group_name):
    return [_all_gather_into_tensor(x, group_size, group_name)
            for x in inputs]


def _reduce_scatter_coalesced(inputs, reduce_op, group_size, group_name):
    return [_reduce_scatter_tensor(x, reduce_op, group_size, group_name)
            for x in inputs]


def _all_reduce_coalesced(inputs, reduce_op, group_name):
    return [_all_reduce(x, reduce_op, group_name) for x in inputs]


_IMPLS = {
    "all_gather_into_tensor": _all_gather_into_tensor,
    "reduce_scatter_tensor": _reduce_scatter_tensor,
    "all_reduce": _all_reduce,
    "all_reduce_": _all_reduce_,
    "all_to_all_single": _all_to_all_single,
    "broadcast": _broadcast,
    "broadcast_": _broadcast_,
    "all_gather_into_tensor_coalesced": _all_gather_coalesced,
    "reduce_scatter_tensor_coalesced": _reduce_scatter_coalesced,
    "all_reduce_coalesced": _all_reduce_coalesced,
}


def install(dispatch_key: str = "CUDA") -> None:
    """Route this process's functional collectives on ``dispatch_key``
    tensors (the card's, by default) through :func:`staged_collective`.
    Once per process and key; it lasts for the process."""
    if dispatch_key in _LIBS:
        return
    import torch.distributed._functional_collectives  # noqa: F401 (ops)
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in _OPS:
        lib.impl(name, _IMPLS[name], dispatch_key)
    _LIBS[dispatch_key] = lib
