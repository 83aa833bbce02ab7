"""Roofline terms of one rank's share of a step (port of
``repro.launch.hlo_analysis``; the name is kept so a reader finds the
counterpart).

There is no HLO here: the port runs the step eagerly on ``DTensor``s of
meta tensors (``launch/dryrun.py``), and its inputs are

  * :class:`RankCounters`, a dispatch mode that lets ``DTensor`` desugar
    each op first (the trick ``CommDebugMode`` uses) and then sees the
    rank's *local* ops (not the fake-tensor runs of DTensor's sharding
    propagation, which see global shapes): their FLOPs by ``FlopCounterMode``'s formula
    registry (``torch.utils.flop_counter.flop_registry``), the bytes each
    op reads and writes (its tensor operands and results, once each --
    the counterpart of XLA's "bytes accessed", before any fusion), and
    every functional collective with the bytes of its operand and the
    ranks of its group;
  * ``CommDebugMode``'s collective counts, beside ours;
  * ``torch.distributed._tools.mem_tracker.MemTracker``'s peak bytes of
    the rank's local tensors (parameters, optimizer state and inputs
    tracked as external).

Roofline terms use this card's published peaks (NVIDIA H100 SXM, 700 W):

    compute    = flops_per_chip / 989e12           [s]  (dense bf16)
    memory     = bytes_per_chip / 3.35e12          [s]  (HBM3)
    collective = intra_host_bytes / 450e9          [s]  (NVLink 4, each way)
               + cross_host_bytes / 50e9           [s]

The cross-host rate is a deployment figure, not the card's: a DGX H100
has one 400 Gb/s NDR InfiniBand port a card.  ``collective_bytes`` splits
a collective's bytes by its group: one whose ranks all share a host of
:data:`HOST_CARDS` consecutive ranks is intra-host, any other crosses
hosts.  This replaces the JAX package's split by pod (stride 256):
``cross_host`` / ``intra_host`` take the place of its ``cross_pod`` /
``intra_pod``.  ``collective-permute`` stays in the report at 0 (DTensor
issues none; the pipeline's shift is an all-gather).  Every other field
of the JAX package's report is kept, ``memory``'s XLA buffer classes
(argument, output, temp, alias) as MemTracker's classes.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HOST_CARDS  # cards (ranks) per host

PEAK_FLOPS = 989e12          # bf16 dense / card (H100 SXM)
HBM_BW = 3.35e12             # B/s / card
NVLINK_BW = 450e9            # B/s / card, each way, inside one host
NET_BW = 50e9                # B/s / card across hosts (400 Gb/s NDR)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_FUNCOL = {"all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
           "all_reduce_coalesced": "all-reduce",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all",
           "broadcast": "all-gather", "broadcast_": "all-gather"}


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_ranks(name) -> tuple:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))


class RankCounters(TorchDispatchMode):
    """Per-rank FLOPs, bytes and collectives of the ops run under it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = []     # (kind, bytes, group ranks)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # let DTensor desugar to local ops
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation running an op on fake
            # tensors of the global shapes: not this rank's work.
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        if func.namespace == "_c10d_functional":
            kind = _FUNCOL.get(packet.__name__)
            if kind is not None:
                nbytes = sum(_nbytes(t) for t in _tensors(args[:1]))
                self.collectives.append((kind, nbytes,
                                         _group_ranks(args[-1])))
            return out
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


def _crosses_host(ranks, host_cards: int) -> bool:
    return len({r // host_cards for r in ranks}) > 1


def collective_bytes(records, host_cards: int = HOST_CARDS) -> Dict[str, int]:
    """Per-collective-kind operand bytes of ``RankCounters.collectives``,
    and the intra-host / cross-host split by group (cross-host = the slow
    links; the quantity the pipeline and the int8 compression target)."""
    out = {k: 0 for k in _COLLECTIVES}
    out["count"] = 0
    out["cross_host"] = 0
    out["intra_host"] = 0
    for kind, nbytes, ranks in records:
        out[kind] += nbytes
        out["count"] += 1
        if _crosses_host(ranks, host_cards):
            out["cross_host"] += nbytes
        else:
            out["intra_host"] += nbytes
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


def roofline_terms(flops: float, bytes_accessed: float,
                   intra_bytes: float, cross_bytes: float = 0.0) -> dict:
    compute_t = flops / PEAK_FLOPS
    memory_t = bytes_accessed / HBM_BW
    coll_t = intra_bytes / NVLINK_BW + cross_bytes / NET_BW
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": coll_t}
    dominant = max(terms, key=terms.get)
    bound = max(compute_t, memory_t, coll_t)
    terms.update({
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound,
        "roofline_fraction": compute_t / bound if bound > 0 else 0.0,
    })
    return terms


def memory_report(tracker) -> dict:
    """Peak bytes of one rank from a ``MemTracker`` run: the JAX package's
    buffer classes as MemTracker's (``argument_bytes``: parameters,
    buffers and optimizer state; ``temp_bytes``: activations, gradients
    and temporaries at the peak; no output or alias classes: 0)."""
    snap = tracker.get_tracker_snapshot("peak")
    total = {}
    for per_dev in snap.values():
        for k, v in per_dev.items():
            total[str(getattr(k, "value", k))] = \
                total.get(str(getattr(k, "value", k)), 0) + int(v)
    args = sum(total.get(k, 0) for k in ("Parameter", "Buffer", "Optstate"))
    peak = total.get("Total", 0)
    return {"argument_bytes": args, "output_bytes": 0,
            "temp_bytes": peak - args, "alias_bytes": 0, "peak_bytes": peak,
            "by_class": total}


def analyze(counters: RankCounters, comm_counts: dict, tracker) -> dict:
    """All roofline inputs of one rank's step."""
    coll = collective_bytes(counters.collectives)
    coll["comm_debug_counts"] = {str(k): int(v)
                                 for k, v in comm_counts.items()}
    return {
        "flops_per_chip": float(counters.flops),
        "bytes_per_chip": float(counters.bytes),
        "collectives": coll,
        "memory": memory_report(tracker),
        "roofline": roofline_terms(counters.flops, counters.bytes,
                                   coll["intra_host"], coll["cross_host"]),
    }
