"""The port's model zoo (``repro_torch.models``) on the CPU, held to the
JAX package's (``repro.models``) on the same inputs.

Every architecture runs at its smoke config (float32); the JAX package's
parameters (``init_model`` at PRNGKey(0)) are carried across with
``params_from_numpy``, and token ids (and whisper's frames) come from
numpy seeds.  One parametrised test per check over the ten ARCHS:

  * ``forward`` logits and aux loss within rtol 1e-4, atol 1e-4;
  * ``loss_fn``'s value within rtol 1e-4 and every gradient leaf within
    1e-4 of the largest |gradient| entry of the JAX package's tree;
  * ``prefill`` of 16 tokens, then 4 greedy ``decode_step``s: logits
    within rtol 1e-4, atol 1e-4, and the greedy ids equal at every step;
  * on the port's own parameters (``init_model``): its decode against
    its teacher-forced ``forward`` (rtol and atol 1e-4; MoE capacity
    lifted, as tests/test_models.py does), and ``remat=True`` ==
    ``remat=False``, loss and gradients bit for bit;
  * MoE (llama4, dbrx): expert ids, gates and the capacity keep mask
    equal to the JAX package's routing, also where router columns tie;
  * qwen2-vl's ``pixel_embeds`` forward, and the online-softmax
    (chunked) GQA and MLA attention against the port's dense path and
    the JAX package's chunked path (rtol and atol 1e-4);
  * ``init_model``'s tree for all ten full configs, built on the ``meta``
    device: the leaf paths, shapes and dtypes of
    ``jax.eval_shape(repro.models.init_model)``, and its parameter count,
    which equals ``cfg.num_params()`` wherever the JAX package's does.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import layers as jnl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import layers as tnl  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401

CPU = "cpu"
RTOL = ATOL = 1e-4
MOE_ARCHS = [a for a in ARCHS if j_get_config(a).moe_num_experts]


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    yield
    jax.clear_caches()


def _configs(arch, **changes):
    """(the JAX package's smoke config, the port's), equal field by field."""
    jc = dataclasses.replace(j_smoke(arch), **changes)
    tc = dataclasses.replace(get_smoke_config(arch), **changes)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_params_numpy(arch, **changes):
    jc, _ = _configs(arch, **changes)
    params = jax.jit(lambda k: jtf.init_model(k, jc))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _params(arch, **changes):
    """(JAX params, port params) carrying the same values."""
    pn = _jax_params_numpy(arch, **changes)
    return jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, CPU)


def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens,
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got).astype(np.float64),
                               _np(want).astype(np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _grads(params, cfg, batch, remat=False):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = ttf.loss_fn(live, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), grads


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_repro(arch):
    jc, tc = _configs(arch)
    pj, pt = _params(arch)
    b = _batch(tc)
    lj, aj = jax.jit(lambda p, t, f: jtf.forward(p, jc, t, encoder_input=f))(
        pj, jnp.asarray(b["tokens"]), _jb(b).get("frames"))
    lt, at = ttf.forward(pt, tc, torch.from_numpy(b["tokens"]),
                         encoder_input=_tb(b).get("frames"))
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (
        2, 32, tc.vocab_size)
    _close(lt, lj, msg=arch)
    _close(at, aj, msg=arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_repro(arch):
    jc, tc = _configs(arch)
    pj, pt = _params(arch)
    b = _batch(tc, seed=1)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, jc, b), has_aux=True))(pj, _jb(b))
    lt, gt = _grads(pt, tc, _tb(b))
    _close(lt, lj, atol=0.0, msg=arch)
    gj = jax.tree.leaves(gj)
    assert len(gj) == len(gt)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in gj)
    for g, w in zip(gt, gj):
        assert tuple(g.shape) == w.shape
        _close(g, w, rtol=0.0, atol=1e-4 * scale, msg=arch)


# --------------------------------------------------------- prefill, decode


def _prompt_len(cfg):
    return max(16, cfg.ssm_chunk) if cfg.family in ("ssm", "hybrid") else 16


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_repro(arch):
    jc, tc = _configs(arch)
    pj, pt = _params(arch)
    P, steps = _prompt_len(tc), 4
    b = _batch(tc, S=P, seed=2)
    frames_j, frames_t = _jb(b).get("frames"), _tb(b).get("frames")
    lj, cj = jax.jit(lambda p, t, f: jtf.prefill(
        p, jc, t, P + steps, encoder_input=f))(pj, jnp.asarray(b["tokens"]),
                                               frames_j)
    j_decode = jax.jit(lambda p, t, c, i: jtf.decode_step(p, jc, t, c, i))
    lt, ct = ttf.prefill(pt, tc, torch.from_numpy(b["tokens"]), P + steps,
                         encoder_input=frames_t)
    _close(lt, lj, msg=f"{arch} prefill")
    nj = jnp.argmax(lj[:, -1:], axis=-1)
    nt = torch.argmax(lt[:, -1:], dim=-1)
    for i in range(steps):
        np.testing.assert_array_equal(_np(nt), _np(nj), err_msg=arch)
        lj, cj = j_decode(pj, nj, cj, jnp.asarray(P + i, jnp.int32))
        lt, ct = ttf.decode_step(pt, tc, nt, ct, P + i)
        _close(lt, lj, msg=f"{arch} decode {i}")
        nj = jnp.argmax(lj, axis=-1)
        nt = torch.argmax(lt, dim=-1)
    np.testing.assert_array_equal(_np(nt), _np(nj), err_msg=arch)
    # The caches keep the JAX package's structure and shapes.
    assert [tuple(x.shape) for x in tree_leaves(ct)] == [
        x.shape for x in jax.tree.leaves(cj)]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    # Capacity drops differ between full-sequence and per-token routing
    # (inherent to capacity-based MoE); lift them for the equivalence.
    _, tc = _configs(arch, moe_capacity_factor=16.0)
    pt = ttf.init_model(0, tc, device=CPU)
    S = 2 * _prompt_len(tc)
    b = _tb(_batch(tc, S=S, seed=3))
    tokens = b["tokens"]
    with torch.no_grad():
        full, _ = ttf.forward(pt, tc, tokens, encoder_input=b.get("frames"))
        half = S // 2
        lg, caches = ttf.prefill(pt, tc, tokens[:, :half], S,
                                 encoder_input=b.get("frames"))
        _close(lg, full[:, :half], msg=arch)
        for i in range(half, S):
            lg, caches = ttf.decode_step(pt, tc, tokens[:, i:i + 1], caches,
                                         i)
            _close(lg[:, 0], full[:, i], msg=f"{arch} pos {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise(arch):
    _, tc = _configs(arch)
    pt = ttf.init_model(0, tc, device=CPU)
    b = _tb(_batch(tc, seed=4))
    l0, g0 = _grads(pt, tc, b, remat=False)
    l1, g1 = _grads(pt, tc, b, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, c) for a, c in zip(g0, g1))


def test_vlm_pixel_embeds_match_repro():
    jc, tc = _configs("qwen2-vl-72b")
    pj, pt = _params("qwen2-vl-72b")
    b = _batch(tc, S=16, seed=6)
    pix = np.random.default_rng(6).standard_normal(
        (2, 8, tc.d_model)).astype(np.float32)
    lj, _ = jax.jit(lambda p, t, x: jtf.forward(p, jc, t, pixel_embeds=x))(
        pj, jnp.asarray(b["tokens"]), jnp.asarray(pix))
    lt, _ = ttf.forward(pt, tc, torch.from_numpy(b["tokens"]),
                        pixel_embeds=torch.from_numpy(pix))
    assert tuple(lt.shape) == (2, 24, tc.vocab_size)
    _close(lt, lj)


@pytest.mark.parametrize("attention", ["gqa", "mla"])
def test_chunked_attention_matches_dense_and_repro(attention, monkeypatch):
    # The online-softmax paths (FLASH_THRESHOLD and up) at a 16-token
    # chunk: against the port's dense path and the JAX package's chunked
    # path, on layer 0's carried parameters.
    arch = "qwen3-0.6b" if attention == "gqa" else "minicpm3-4b"
    jc, tc = _configs(arch)
    pn = _jax_params_numpy(arch)
    p = {k: np.array(v[0]) for k, v in pn["layers"]["attn"].items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    B, S = 2, 64
    x = np.random.default_rng(7).standard_normal(
        (B, S, tc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    xt, post = torch.from_numpy(x), torch.from_numpy(pos.copy())
    forward_t = tnl.attention_forward if attention == "gqa" else \
        tnl.mla_forward
    forward_j = jnl.attention_forward if attention == "gqa" else \
        jnl.mla_forward
    dense = forward_t(pt, tc, xt, post)
    for mod in (tnl, jnl):
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 1)
        monkeypatch.setattr(mod, "FLASH_KV_CHUNK", 16)
    flash = forward_t(pt, tc, xt, post)
    want = jax.jit(lambda p, x, q: forward_j(p, jc, x, q))(
        pj, jnp.asarray(x), jnp.asarray(pos))
    _close(flash, dense)
    _close(flash, want)


# ------------------------------------------------------------ MoE routing


def _jax_routes(p, cfg, x):
    """The JAX package's routing of x (moe_forward's steps, one group):
    (gates, expert ids, (eid_s, slot_c, keep)) as numpy."""
    T = x.shape[0] * x.shape[1]
    xf = jnp.asarray(x).reshape(T, -1)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, cfg.moe_top_k)
    gate_vals = gate_vals / jnp.clip(jnp.sum(gate_vals, -1, keepdims=True),
                                     1e-9)
    cap = int(max(1, round(T * cfg.moe_top_k / cfg.moe_num_experts
                           * cfg.moe_capacity_factor)))
    _, (eid_s, slot_c, _, _, keep) = jnl._moe_group_dispatch(
        xf, expert_idx.reshape(-1), gate_vals.reshape(-1), cap,
        cfg.moe_num_experts)
    return [np.asarray(a) for a in (gate_vals, expert_idx, eid_s, slot_c,
                                    keep)]


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routes_match_repro(arch, tie):
    jc, tc = _configs(arch)
    pn = _jax_params_numpy(arch)
    p = {k: np.array(v[0]) for k, v in pn["layers"]["moe"].items()
         if k != "shared"}
    if tie:
        # Two experts with one router column: every token's two
        # probabilities tie, and both packages take the lower id first.
        p["router"][:, 3] = p["router"][:, 1]
    # A direction shared by every token skews the routing toward a few
    # experts, so capacity drops some of their entries.
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 32, tc.d_model))
         + 2.0 * rng.standard_normal(tc.d_model)).astype(np.float32)
    want = _jax_routes({k: jnp.asarray(v) for k, v in p.items()}, jc, x)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    _, gates, ids = tnl.moe_route(pt, tc, torch.from_numpy(x))
    cap = tnl.moe_capacity(tc, x.shape[0] * x.shape[1])
    _, eid_s, slot_c, keep = tnl.moe_dispatch_meta(ids.reshape(-1), cap)
    np.testing.assert_array_equal(ids.numpy(), want[1])
    np.testing.assert_array_equal(eid_s.numpy(), want[2])
    np.testing.assert_array_equal(slot_c.numpy(), want[3])
    np.testing.assert_array_equal(keep.numpy(), want[4])
    assert not keep.all()                      # capacity drops some
    _close(gates, want[0], atol=0.0)
    if tie:
        assert (ids[:, 0] != 3).all()           # never the higher of a tie


# --------------------------------------------------------- full configs


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_tree_matches_repro(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    shapes = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0),
                                                   jc))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tree = ttf.init_model(0, tc, device="meta")
    leaves = tree_leaves(tree)
    assert all(x.device.type == "meta" for x in leaves)
    from repro_torch.checkpoint.manager import _flatten_with_paths
    got = [(k, tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for k, x in _flatten_with_paths(tree)]
    want = [("/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                      for q in path), s.shape, str(s.dtype))
            for path, s in flat]
    assert got == want
    count = ttf.param_count(tree)
    jcount = sum(int(np.prod(s.shape)) for _, s in flat)
    assert count == jcount
    if jcount == jc.num_params():
        assert count == tc.num_params()
