"""The plain reference at small n: its Sturm counts agree with a dense
solve, it certifies the exact eigenvalues, and it rejects a zeroed
output, a sign-flipped output and a float32 solve."""

import numpy as np
import pytest
import torch

from portbench import harness, inputs, reference

CONFIGS = {
    "uniform": {"generator": "uniform", "params": {
        "d_low": -1.0, "d_high": 1.0, "e_low": 0.1, "e_high": 0.3}},
    "glued_wilkinson": {"generator": "glued_wilkinson", "params": {
        "block": 21, "glue": 1e-4, "shift": 1.0}},
}
LIMIT = 64.0


def _problems(name, n=96, count=3, seed=2**31 + 11):
    conf = CONFIGS[name]
    gen = harness.load_module("generators", conf["generator"])
    return inputs.make_problems(gen, conf["params"], n, count, seed)


def _dense(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _exact(d, e, dtype=np.float64):
    return np.stack([np.linalg.eigvalsh(_dense(a, b).astype(dtype))
                     for a, b in zip(d, e)]).astype(np.float64)


def _judge(d, e, lam, first=None, graded=None, index=None):
    P, k = lam.shape
    first = np.zeros(P, dtype=np.int64) if first is None else first
    if index is None:
        index = first[:, None] + np.arange(k)[None]
    graded = (np.tile(np.arange(k), (P, 1)) if graded is None else graded)
    return reference.certify(d, e, lam, index, graded, LIMIT, "cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_counts_agree_with_a_dense_solve(name):
    d, e = _problems(name)
    lam = _exact(d, e)
    rng = np.random.default_rng(0)
    x = rng.uniform(lam.min() - 0.1, lam.max() + 0.1, size=(len(d), 200))
    got = reference.sturm_counts(torch.as_tensor(d), torch.as_tensor(e),
                                 torch.as_tensor(x)).numpy()
    want = (lam[:, None, :] <= x[:, :, None]).sum(axis=2)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_exact_eigenvalues_certify_well_inside_the_limit(name):
    d, e = _problems(name)
    v = _judge(d, e, _exact(d, e))
    assert v["missed"] == 0
    assert v["err_eps"] <= 16
    assert v["checked"] == v["graded"] == d.size


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_slice_is_judged_at_its_own_indices(name):
    d, e = _problems(name)
    lam = _exact(d, e)
    first = np.array([0, 40, 88])
    sl = np.stack([lam[p, f:f + 8] for p, f in enumerate(first)])
    assert _judge(d, e, sl, first=first)["missed"] == 0
    # the right values at the wrong indices fail
    assert _judge(d, e, sl, first=first + 1)["missed"] > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_values_are_judged_at_indices_that_need_not_be_contiguous(name):
    d, e = _problems(name)
    lam = _exact(d, e)
    n = lam.shape[1]
    index = np.tile(np.r_[0:4, n - 4:n], (len(d), 1))
    edges = np.take_along_axis(lam, index, axis=1)
    graded = np.tile(np.arange(8), (len(d), 1))
    assert _judge(d, e, edges, index=index, graded=graded)["missed"] == 0
    assert _judge(d, e, edges, index=index[:, ::-1].copy(),
                  graded=graded)["missed"] > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("fault", ["zeroed", "sign_flipped", "float32",
                                   "one_altered", "nan"])
def test_the_reference_rejects_wrong_outputs(name, fault):
    d, e = _problems(name)
    lam = _exact(d, e)
    if fault == "zeroed":
        bad = np.zeros_like(lam)
    elif fault == "sign_flipped":
        bad = np.sort(-lam, axis=1)
    elif fault == "float32":
        bad = _exact(d, e, np.float32)
    elif fault == "one_altered":
        bad = lam.copy()
        bad[1, 50] += 200 * reference.EPS * reference.tinf(d, e)[1]
    else:
        bad = lam.copy()
        bad[2, 3] = np.nan
    v = _judge(d, e, bad)
    assert v["missed"] > 0
    assert v["err_eps"] > LIMIT


def test_a_float32_solve_reads_far_above_the_limit():
    d, e = _problems("uniform")
    v = _judge(d, e, _exact(d, e, np.float32))
    assert v["err_eps"] >= 2.0 ** 20


def test_graded_positions_keep_both_ends():
    rng = np.random.default_rng(3)
    pos = reference.graded_positions(1000, 10, rng)
    assert len(pos) == 10 and pos[0] == 0 and pos[-1] == 999
    assert len(set(pos)) == 10
    assert list(reference.graded_positions(5, 10, rng)) == list(range(5))
    assert reference.limit_reading(reference.BEYOND) == "> 2^40"
