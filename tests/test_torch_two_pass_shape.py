"""The launch shapes of the two-pass row update
(``kernels.boundary_update.launch_shape``) and of the QL kernel
(``kernels.sterf.launch_shape``), and the plain QL loop's guarded rotation,
checked on the CPU.

The shapes decide how the card is filled, never what a lane computes, so
the kernels' results need no card here; this pins the choice itself: the
path switches from a team per column to output tiles between r = 4 and
r = 5 (the tensor cores in float64, SIMT tiles in float32), the tiles
cover every row and root, a block's shared memory stays within the Hopper
limit and the grid within CUDA's; the wrappers' constants are the ones
compiled into the sources.  The plain QL loop (``core.sterf``) is held to
LAPACK on inputs scaled by 1e+-150, where f^2 + g^2 leaves the reciprocal
square root's range and the rotations take hypot.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sla = pytest.importorskip("scipy.linalg")

from repro_torch.core import make_family  # noqa: E402
from repro_torch.core import sterf as tsterf  # noqa: E402
from repro_torch.kernels import boundary_update as bu  # noqa: E402
from repro_torch.kernels import sterf as ks  # noqa: E402

CSRC = Path(bu.__file__).resolve().parents[1] / "csrc"
DTYPES = [torch.float64, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [64, 130, 2048, 8192, 16384])
@pytest.mark.parametrize("r", [1, 3, 4, 5, 64, 65, "K"])
def test_row_update_shape_covers_fits_and_switches_at_five_rows(r, K, dtype):
    r = K if r == "K" else r
    for B in (1, 2, 64):
        s = bu.launch_shape(B, r, K, dtype)
        gx, gy, gz = s.grid
        if r <= 4:
            assert s.path == "team" and s.team == bu.TEAM == 8
            # One team per root column, whole warps, every row in a block.
            assert s.tile_cols * s.team == s.threads and s.threads % 32 == 0
            assert s.tile_rows == r and (gy, gz) == (B, 1)
            assert gx * s.tile_cols >= K > (gx - 1) * s.tile_cols
        else:
            assert s.path == ("mma" if dtype == torch.float64 else "simt")
            assert s.team == 0 and gz == B
            assert gx * s.tile_cols >= K > (gx - 1) * s.tile_cols
            assert gy * s.tile_rows >= r > (gy - 1) * s.tile_rows
        assert 0 <= s.smem <= bu.SMEM_LIMIT == 232448
        assert all(1 <= g <= lim for g, lim in zip(s.grid, bu.GRID_LIMIT))
    assert bu.launch_shape(1, r, K, dtype)._replace(grid=None) == \
        bu.launch_shape(64, r, K, dtype)._replace(grid=None)


def test_row_update_shapes_of_the_paths():
    s = bu.launch_shape(1, 4096, 4096, torch.float64)
    assert (s.path, s.tile_rows, s.tile_cols, s.tile_poles) == (
        "mma", 128, 128, 32)
    assert s.grid == (32, 32, 1) and s.threads == 512
    # R ring (3 x 128 x 36), y double buffer (2 x 128 x 36), d and w
    # (3 x 2 x 32) and three column vectors (3 x 128), in doubles: one
    # block per SM.
    assert s.smem == 23616 * 8 == 188928
    s = bu.launch_shape(2, 3, 8192, torch.float64)
    assert s.path == "team" and s.grid == (256, 2, 1)
    assert s.smem == 3 * 256 * 5 * 8
    s = bu.launch_shape(1, 5, 4096, torch.float32)
    assert s.path == "simt" and s.grid == (64, 1, 1) and s.smem == 0
    # Past CUDA's grid: 65536 lanes (grid y or z).
    assert bu.launch_shape(65536, 3, 64, torch.float64).grid[1] > 65535
    assert bu.launch_shape(65536, 64, 64, torch.float64).grid[2] > 65535


def test_the_row_update_constants_match_the_source():
    src = (CSRC / "boundary_update.cu").read_text()
    common = (CSRC / "secular_common.cuh").read_text()
    assert re.search(r"constexpr int TEAM = (\d+);", common)[1] == str(bu.TEAM)
    for name in ("MAX_R_COL", "COL_THREADS", "COL_TILE", "COL_STAGES",
                 "MMA_BM", "MMA_BN", "MMA_BK", "MMA_STAGES", "MMA_THREADS",
                 "BM", "BN", "BK", "TILE_THREADS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m[1]) == getattr(bu, name), name
    assert re.search(r"constexpr int MMA_LDK = MMA_BK \+ (\d+);", src)[1] == \
        str(bu.MMA_LDK - bu.MMA_BK)
    assert "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64" in src
    codes = dict(re.findall(r"k(Team|Mma|Simt) = (\d)", src))
    assert {k.lower(): int(v) for k, v in codes.items()} == bu._PATH_CODE


@pytest.mark.parametrize("dtype,n_max", [(torch.float64, 14528),
                                         (torch.float32, 29056)])
def test_ql_shape_holds_as_many_rows_as_shared_memory_takes(dtype, n_max):
    item = 8 if dtype == torch.float64 else 4
    for n in (1, 2, 256, 4096, n_max, n_max + 1, 16384, 40000):
        s = ks.launch_shape(3, n, dtype)
        assert s.threads == 32 and s.grid == 3
        assert s.rows == min(n, n_max) and s.smem == 2 * s.rows * item
        assert s.smem <= ks.SMEM_LIMIT == 232448
    assert 2 * (n_max + 1) * item > ks.SMEM_LIMIT


def test_the_ql_constants_match_the_source():
    src = (CSRC / "sterf.cu").read_text()
    assert re.search(r"constexpr int WARP = (\d+);", src)[1] == str(
        ks.THREADS)
    assert re.search(r"constexpr int PROBE_ROWS = (\d+);", src)[1] == str(
        ks.PROBE_ROWS)
    for tag, dtype in (("double", torch.float64), ("float", torch.float32)):
        lo, hi = tsterf.RSQRT_RANGE[dtype]
        block = src.split(f"template <> struct Ql<{tag}>")[1].split("};")[0]
        got = [int(x) for x in re.findall(r"return 0x1p(-?\d+)f?;", block)]
        assert got == [round(math.log2(lo)), round(math.log2(hi))]


def _tinf(d, e):
    row = np.abs(d).copy()
    row[:-1] += np.abs(e)
    row[1:] += np.abs(e)
    return float(row.max())


@pytest.mark.parametrize("scale", [1e150, 1e-150, 1.0])
def test_plain_ql_takes_hypot_outside_the_rsqrt_range(monkeypatch, scale):
    """At n = 64: scaled by 1e+-150, f^2 + g^2 leaves [2^-960, 2^960] and
    nearly every rotation takes the guarded hypot branch; unscaled, only
    the shifts (one hypot per sweep) do.  Both are held to LAPACK's stebz
    at the conformance bar, 64 eps ||T||_inf."""
    calls = []
    hypot = math.hypot

    def counting(a, b):
        calls.append(b != 1.0)          # b == 1: a sweep's shift
        return hypot(a, b)

    monkeypatch.setattr(tsterf.math, "hypot", counting)
    d, e = make_family("normal", 64, seed=3)
    d, e = d * scale, e * scale
    lam, steps = tsterf.sterf_plain(torch.tensor(d)[None],
                                    torch.tensor(e)[None])
    rot = int(steps[0])
    guarded = sum(calls)
    if scale == 1.0:
        assert guarded == 0
    else:
        assert guarded > 0.9 * rot
    ref = sla.eigh_tridiagonal(d, e, eigvals_only=True, lapack_driver="stebz")
    np.testing.assert_allclose(lam[0].numpy(), ref, rtol=0,
                               atol=64 * np.finfo(float).eps * _tinf(d, e))
