"""Read a built kernel library's SASS (``cuobjdump -sass``): the one SASS
reader of chip_smoke.py and the timing scripts.

    from sass import count, instructions_per_item
    count(lib, "boundary_update", "DMMA")
    instructions_per_item(lib, "weights_kernelIdE")

``lib`` is the path of a built ``lib<name>.so``.  Both return None where
the CUDA toolkit has no cuobjdump.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

# The FP64 pipe's instructions in SASS (Hopper: 64 lanes an SM, two warp
# instructions a cycle).  MUFU.RCP64H, the reciprocal estimate that every
# FP64 division and reciprocal starts with, runs on another pipe.
FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP")


def _functions(lib):
    """[(mangled name, SASS text)] of the functions in ``lib``, or None
    where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    return [tuple(fn.split("\n", 1)) if "\n" in fn else (fn, "")
            for fn in re.split(r"\n\s*Function : ", sass)[1:]]


def count(lib, kernel, opcode):
    """How many ``opcode`` instructions the functions of ``lib`` whose
    name contains ``kernel`` hold."""
    fns = _functions(lib)
    if fns is None:
        return None
    return sum(len(re.findall(rf"\b{opcode}\b", body))
               for name, body in fns if kernel in name)


def instructions_per_item(lib, kernel, per_item=1):
    """(FP64-pipe instructions, all instructions) per item (pair, term or
    row) of the hot loop of the kernel function whose mangled name
    contains ``kernel`` (for instance ``weights_kernelIdE``, its float64
    instance).

    A diagnostic of the code as compiled, not a bound on the function:
    a loop that issues more instructions than it needs counts them all.

    The loops are the spans of the backward branches.  The hot loop is an
    innermost one (it holds no other loop) that reads shared memory (LDS)
    and forms reciprocal estimates (MUFU.RCP64H, one per division or
    reciprocal, ``per_item`` of them an item); of those, the one with the
    most FP64 instructions per estimate (the secular sweeps' g/g' term
    among the root solve's lighter sweeps).  Its counts over its
    estimates, times ``per_item``, are an item's, however far the
    compiler unrolled it."""
    fns = _functions(lib)
    if fns is None:
        return None
    for name, body in fns:
        if kernel not in name:
            continue
        code = [(int(addr, 16), re.sub(r"^@!?U?P\w+\s+", "", text))
                for addr, text in re.findall(
                    r"/\*([0-9a-f]{4,})\*/\s+([A-Z@][^;]*);", body)]
        loops = []
        for addr, text in code:
            hit = re.match(r"BRA\b.*?0x([0-9a-f]+)", text)
            if hit and int(hit.group(1), 16) <= addr:
                loops.append((int(hit.group(1), 16), addr))
        best = None
        for lo, hi in loops:
            if any(lo <= a and b <= hi and (a, b) != (lo, hi)
                   for a, b in loops):
                continue
            ops = [text.split()[0] for addr, text in code
                   if lo <= addr <= hi]
            rcp = sum(op.startswith("MUFU.RCP64H") for op in ops)
            if not rcp or not any(op.startswith("LDS") for op in ops):
                continue
            fp64 = sum(op.split(".")[0] in FP64_OPS for op in ops)
            item = (fp64 * per_item / rcp, len(ops) * per_item / rcp)
            best = item if best is None or item[0] > best[0] else best
        return best
    return None
