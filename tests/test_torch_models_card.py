"""The port's model zoo and trainer on the card (marker ``gpu``; skipped
without one).  Imports no JAX, so it runs on the card's machine with

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
        tests/test_torch_models_card.py

  * ``forward`` and ``loss_fn`` (value and gradients) of one smoke
    config of each family -- dense (qwen3), MLA (minicpm3), MoE (llama4),
    SSM (mamba2), hybrid (zamba2), audio (whisper), vlm (qwen2-vl),
    float32 -- on the card against the same parameters and inputs on the
    CPU, within rtol 1e-4 and atol 1e-4 (gradients: 1e-4 of the largest
    |gradient| entry), with TF32 off;
  * the trainer (``launch.train.main``) for 3 steps on the card with a
    served curvature probe: finite losses, CUDA-event step times, the
    edges bucket's requests == probes + 1 and 0 errors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.gpu

FAMILIES = ["qwen3-0.6b", "minicpm3-4b", "llama4-maverick-400b-a17b",
            "mamba2-130m", "zamba2-7b", "whisper-small", "qwen2-vl-72b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = old


def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
        for k in ("tokens", "labels")}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    return batch


def _loss_and_grads(params, cfg, batch):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = ttf.loss_fn(live, cfg, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach().cpu(), [g.cpu() for g in grads]


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_loss_on_card_match_cpu(cuda_device, arch):
    cfg = get_smoke_config(arch)
    params = ttf.init_model(0, cfg, device="cpu")
    batch = _batch(cfg)
    on_card = tree_map(lambda x: x.to(cuda_device), params)
    batch_card = {k: v.to(cuda_device) for k, v in batch.items()}
    with torch.no_grad():
        want, aux_w = ttf.forward(params, cfg, batch["tokens"],
                                  encoder_input=batch.get("frames"))
        got, aux_g = ttf.forward(on_card, cfg, batch_card["tokens"],
                                 encoder_input=batch_card.get("frames"))
    assert got.is_cuda
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4, err_msg=arch)
    np.testing.assert_allclose(float(aux_g), float(aux_w), rtol=1e-4,
                               atol=1e-4)
    lw, gw = _loss_and_grads(params, cfg, batch)
    lg, gg = _loss_and_grads(on_card, cfg, batch_card)
    np.testing.assert_allclose(float(lg), float(lw), rtol=1e-4)
    scale = max(float(g.abs().max()) for g in gw)
    for g, w in zip(gg, gw):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0.0,
                                   atol=1e-4 * scale, err_msg=arch)


def test_trainer_three_steps_on_card(cuda_device, tmp_path):
    rep = ttrain.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "3",
                       "--batch", "4", "--seq", "32", "--lr", "3e-3",
                       "--ckpt-every", "100000", "--ckpt-dir",
                       str(tmp_path), "--spectral-every", "2",
                       "--serve-monitor", "--probe-steps", "4",
                       "--probe-batch", "1", "--target-sharpness", "2.0"])
    assert rep["device"].startswith("cuda")
    assert rep["steps"] == 3 and np.isfinite(rep["losses"]).all()
    assert len(rep["step_event_ms"]) == 3
    assert all(t > 0 for t in rep["step_event_ms"])
    assert rep["probes"] == 1
    buckets = rep["serve"]["buckets"]
    assert buckets["range/n4/k1/float64"]["requests"] == rep["probes"] + 1
    assert sum(b["errors"] for b in buckets.values()) == 0
