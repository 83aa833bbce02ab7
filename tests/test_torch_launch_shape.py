"""The resident merge's launch shape (``kernels.resident_merge.launch_shape``),
checked on the CPU for every resident level of the shapes the main path
runs: n = 1000 and n = 16384 single solves and the B = 64 x 4096 batch.

The cluster size C and the CTA size decide how the card is filled, never
what a lane computes, so the kernel's results need no card here; this
pins the choice itself: C a power of two <= 16, a CTA's shared memory
within the Hopper block limit, lanes x C covering the SMs wherever the
lane count and K allow it (lanes are split as finely as K allows, up to
CTAS_PER_SM CTAs per SM), and a choice that depends on nothing but
(B, K, r, dtype, SM count).
"""

import inspect

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.br_dc import _tree_shape  # noqa: E402
from repro_torch.core.tune import RESIDENT_THRESHOLD_CUDA  # noqa: E402
from repro_torch.kernels import resident_merge as rm  # noqa: E402

H100_SMS = 132
LEAF = 32


def _resident_levels(n, batch):
    """(K, lanes) of every level of an n-point solve of ``batch`` problems
    that the resident kernel takes (the root merge never does)."""
    N, L = _tree_shape(n, LEAF)
    out = []
    for level in range(L):
        nm = N // (2 * LEAF << level)
        K = 2 * LEAF << level
        if nm > 1 and K <= RESIDENT_THRESHOLD_CUDA:
            out.append((K, batch * nm))
    return out


LEVELS = sorted({lv for n, batch in ((1000, 1), (16384, 1), (4096, 64))
                 for lv in _resident_levels(n, batch)})


def test_levels_are_the_main_paths():
    assert _resident_levels(16384, 1) == [
        (64, 256), (128, 128), (256, 64), (512, 32), (1024, 16), (2048, 8)]
    assert _resident_levels(1000, 1) == [(64, 16), (128, 8), (256, 4),
                                         (512, 2)]
    assert _resident_levels(4096, 64)[-1] == (2048, 128)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("K,lanes", LEVELS)
def test_launch_shape_fits_and_fills_the_card(K, lanes, r, dtype):
    s = rm.launch_shape(lanes, K, r, dtype, H100_SMS)
    C = s.cluster
    assert C >= 1 and C & (C - 1) == 0 and C <= rm.MAX_CLUSTER == 16
    assert s.smem == rm.smem_bytes(r, K, dtype) <= rm.SMEM_LIMIT == 232448
    # Enough CTAs for every SM, unless K is too small to split that far
    # (a CTA keeps at least MIN_ROOTS_PER_CTA roots).
    cap = min(rm.MAX_CLUSTER, max(1, K // rm.MIN_ROOTS_PER_CTA))
    assert lanes * C >= min(H100_SMS, lanes * cap)
    # As fine as K allows, up to CTAS_PER_SM CTAs per SM.
    assert C == cap or lanes * 2 * C > rm.CTAS_PER_SM * H100_SMS
    assert C == 1 or lanes * C <= rm.CTAS_PER_SM * H100_SMS
    # Whole warps, at most one team per root of the CTA's share.
    share = -(-K // C)
    assert s.team == rm.TEAM and s.threads % 32 == 0
    assert 32 <= s.threads <= rm.MAX_THREADS
    assert s.threads <= max(32, -(-share * s.team // 32) * 32)


def test_main_path_cluster_sizes():
    shapes = {K: rm.launch_shape(lanes, K, 3, torch.float64, H100_SMS)
              for K, lanes in _resident_levels(16384, 1)}
    assert {K: s.cluster for K, s in shapes.items()} == {
        64: 2, 128: 4, 256: 8, 512: 16, 1024: 16, 2048: 16}
    assert all(s.threads == rm.MAX_THREADS == 256 for s in shapes.values())
    # Two CTAs of the largest level (plus the 1 KiB the hardware reserves
    # for each) share one SM's 228 KiB, so 256 CTAs run at once.
    assert shapes[2048].smem == 114688
    assert 2 * (shapes[2048].smem + 1024) <= 228 * 1024
    batch = {K: rm.launch_shape(lanes, K, 3, torch.float64, H100_SMS)
             for K, lanes in _resident_levels(4096, 64)}
    assert {K: s.cluster for K, s in batch.items()} == {
        64: 1, 128: 1, 256: 1, 512: 2, 1024: 4, 2048: 8}
    # The kernel table's shape: 64 lanes at K = 2048.
    assert rm.launch_shape(64, 2048, 3, torch.float64, H100_SMS).cluster == 16


def test_launch_shape_depends_on_its_arguments_only(monkeypatch):
    assert list(inspect.signature(rm.launch_shape).parameters) == [
        "B", "K", "r", "dtype", "sm_count"]

    def no_device(*a, **k):
        raise AssertionError("launch_shape queried the device")

    for name in ("is_available", "device_count", "current_device",
                 "get_device_properties"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    first = [rm.launch_shape(lanes, K, 3, torch.float64, H100_SMS)
             for K, lanes in LEVELS]
    again = [rm.launch_shape(lanes, K, 3, torch.float64, H100_SMS)
             for K, lanes in reversed(LEVELS)]
    assert first == again[::-1]
    # Another SM count may change the shape, the same one never does.
    assert rm.launch_shape(128, 2048, 3, torch.float64, 114).cluster == 4
    assert rm.launch_shape(128, 2048, 3, torch.float64, 132).cluster == 8
    assert rm.launch_shape(600, 2048, 3, torch.float64, 132).cluster == 1
    assert rm.launch_shape(1, 2048, 3, torch.float64, 132).cluster == 16


def test_the_kernels_team_and_sizes_match_the_wrapper():
    """The wrapper's constants are the ones compiled into the sources (the
    kernel also refuses a launch whose team or CTA size disagrees)."""
    import re
    from pathlib import Path
    csrc = Path(rm.__file__).resolve().parents[1] / "csrc"
    common = (csrc / "secular_common.cuh").read_text()
    merge = (csrc / "resident_merge.cu").read_text()
    assert re.search(r"constexpr int TEAM = (\d+);", common)[1] == str(rm.TEAM)
    assert re.search(r"constexpr int MAX_THREADS = (\d+);", merge)[1] == str(
        rm.MAX_THREADS)
    assert re.search(r"constexpr int MAX_CLUSTER = (\d+);", merge)[1] == str(
        rm.MAX_CLUSTER)
