"""The port's optimizers and spectral governor (``repro_torch.optim``) on
the CPU, held to the JAX package (``repro.optim``).

  * Five steps of sgd, adamw and adafactor from the same state -- the
    JAX package's parameters and optimizer state after one step, carried
    across with ``tree_from_numpy`` -- under the same gradients: every
    parameter and state leaf within rtol 1e-6 (float32 arithmetic in
    another order), ``count`` int32 and equal.
  * adafactor keeps factored second moments over the trailing two axes.
  * The governor's update sequence equals the JAX package's exactly
    (float ==) for the same lam inputs, NaN, inf, 0 and negative values
    among them; its probes record onto the port's ``SOLVE_COUNTER``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import clear_plan_cache as j_clear_plan_cache  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim.spectral_adapt import SpectralGovernor as JGov  # noqa: E402
from repro_torch.core import SOLVE_COUNTER  # noqa: E402
from repro_torch.optim import (OPTIMIZERS, SpectralGovernor,  # noqa: E402
                               adafactor, get_optimizer)
from repro_torch.tree import tree_from_numpy, tree_leaves  # noqa: E402

CPU = "cpu"


from _torch_threads import _one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    yield
    j_clear_plan_cache()
    jax.clear_caches()


def _params(rng):
    return {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "b": rng.standard_normal(6).astype(np.float32),
            "blk": {"k": rng.standard_normal((2, 3, 5)).astype(np.float32),
                    "s": np.asarray(rng.standard_normal(),
                                    np.float32).reshape(())}}


def _grads(rng, params):
    return jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)


def _assert_tree_close(got, want, rtol=1e-6):
    want_leaves = jax.tree.leaves(want)
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert g.dtype == getattr(torch, w.dtype.name), (g.dtype, w.dtype)
        assert tuple(g.shape) == w.shape
        if w.dtype.kind == "i":
            assert np.array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                       atol=rtol * max(1.0, float(
                                           np.abs(w).max())))


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_five_steps_match_repro_from_carried_state(name):
    rng = np.random.default_rng(21)
    kw = {"weight_decay": 0.05} if name == "adafactor" else {}
    j_opt = jopt.get_optimizer(name, **kw)
    t_opt = get_optimizer(name, **kw)
    assert t_opt.name == j_opt.name == name
    pj = jax.tree.map(jnp.asarray, _params(rng))
    sj = j_opt.init(pj)
    pj, sj = j_opt.apply(pj, jax.tree.map(jnp.asarray, _grads(rng, pj)), sj)
    # Carry the JAX package's state across, then step both.
    pt = tree_from_numpy(jax.tree.map(np.asarray, pj), CPU)
    st = tree_from_numpy(jax.tree.map(np.asarray, sj), CPU)
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 1
    for step in range(5):
        g = _grads(rng, pj)
        scale = 1.0 if step % 2 else 0.5
        pj, sj = j_opt.apply(pj, jax.tree.map(jnp.asarray, g), sj,
                             lr_scale=scale)
        pt, st = t_opt.apply(pt, tree_from_numpy(g, CPU), st,
                             lr_scale=scale)
        _assert_tree_close(pt, pj)
        _assert_tree_close(st, sj)
    assert int(st["count"]) == 6


def test_tree_from_numpy_defaults_to_the_card():
    """With no device named, a carried-across tree lands on the card, as
    every entry point's tensors do; with no card that is an error, never
    a quiet copy to the CPU."""
    tree = {"w": np.ones((2, 3), np.float32),
            "count": np.asarray(3, np.int32)}
    if torch.cuda.is_available():
        got = tree_from_numpy(tree)
        assert {x.device.type for x in tree_leaves(got)} == {"cuda"}
        assert got["count"].dtype == torch.int32
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tree_from_numpy(tree)
    got = tree_from_numpy(tree, CPU)
    assert {x.device.type for x in tree_leaves(got)} == {"cpu"}
    assert got["count"].dtype == torch.int32 and int(got["count"]) == 3


def test_init_states_match_repro_in_structure():
    rng = np.random.default_rng(2)
    p_np = _params(rng)
    for name in OPTIMIZERS:
        want = jopt.get_optimizer(name).init(jax.tree.map(jnp.asarray, p_np))
        got = get_optimizer(name).init(tree_from_numpy(p_np, CPU))
        _assert_tree_close(got, want)


def test_adafactor_state_is_factored():
    rng = np.random.default_rng(4)
    state = adafactor().init(tree_from_numpy(_params(rng), CPU))
    v = state["v"]
    assert set(v["w"]) == {"vr", "vc"}
    assert tuple(v["w"]["vr"].shape) == (4,)
    assert tuple(v["w"]["vc"].shape) == (6,)
    assert tuple(v["blk"]["k"]["vr"].shape) == (2, 3)
    assert tuple(v["blk"]["k"]["vc"].shape) == (2, 5)
    assert set(v["b"]) == {"v"} and tuple(v["b"]["v"].shape) == (6,)
    assert tuple(v["blk"]["s"]["v"].shape) == ()
    assert state["count"].dtype == torch.int32


@pytest.mark.parametrize("ema", [0.0, 0.7])
def test_governor_updates_equal_repro_exactly(ema):
    lams = [0.0, 50.0, float("nan"), 400.0, -3.0, float("inf"), 250.0,
            1e-9, 0.0, -1e6, 120.0, float("-inf"), 99.5]
    for first in (lams, lams[2:], [-5.0] + lams):
        g_t = SpectralGovernor(target_sharpness=100.0, ema=ema)
        g_j = JGov(target_sharpness=100.0, ema=ema)
        for lam in first:
            assert g_t.update(lam) == g_j.update(lam), lam
            assert (g_t.scale, g_t.lam_max, g_t.probes, g_t._probed) == \
                (g_j.scale, g_j.lam_max, g_j.probes, g_j._probed), lam
    gov = SpectralGovernor(period=5)
    assert [s for s in range(12) if gov.should_probe(s)] == [0, 5, 10]


def test_governor_probes_record_on_the_ports_counter():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((24, 24)).astype(np.float32)
    A = torch.from_numpy((A + A.T) / 2)
    top = float(torch.linalg.eigvalsh(A.double())[-1])
    like = {"x": torch.zeros(24)}
    start = len(SOLVE_COUNTER.probe_events())
    gov = SpectralGovernor(target_sharpness=1.0, ema=0.0)
    scale = gov.probe(lambda v: {"x": A @ v["x"]}, like,
                      torch.Generator().manual_seed(0), num_steps=24)
    assert gov.lam_max == pytest.approx(top, rel=1e-4)
    assert scale == max(gov.min_scale, min(1.0, 1.0 / gov.lam_max))
    from repro_torch.spectral import lanczos_tridiag_batch
    alpha, beta = lanczos_tridiag_batch(
        lambda v: {"x": A @ v["x"]}, {"x": torch.ones(2, 24)}, 8)
    gov.probe_tridiag(alpha, beta)
    assert len(SOLVE_COUNTER.probe_events(start)) == 2
