"""``remat``: each encoder and decoder layer under ``torch.utils.checkpoint``,
its dropout draws replayed from the explicit generator in the recompute.

As JAX's own check (``tests/test_model.py:243-270``): with dropout 0.1 and
one seeded generator, remat on and off give the same loss and the same
gradient of every parameter (rtol 1e-6: the recompute runs the same ops on
the same draws; atol 1e-7, JAX's: the shared embedding's gradient sums its
source and target lookups in the order autograd reaches them, which the
recompute changes, 1.9e-9 at most here), the same parameter names, and
leave the generator in the same state, so later draws do not move.  Run
on the three attention paths the port trains through: the default one,
``fused_attn_train`` (bf16, its twin on the CPU; its seed is drawn from
the generator) and ``flash_training`` (its twin on the CPU).
"""

import numpy as np
import pytest
import torch

from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.ops import flash_train as ft
from smer_music_generation_tpu_torch.ops import train_attention as ta

V = 50
PATHS = {
    "default": dict(),
    "fused_attn_train": dict(fused_attn_train=True, dtype=torch.bfloat16),
    "flash_training": dict(flash_training=True),
}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(3, V, (2, 128)))
    tgt = torch.from_numpy(rng.integers(3, V, (2, 128)))
    spm = torch.zeros(2, 128, dtype=torch.bool)
    spm[1, 100:] = True
    tpm = torch.zeros(2, 128, dtype=torch.bool)
    tpm[1, 90:] = True
    return src, tgt, spm, tpm


def _step(path: str, remat: bool):
    """One forward and backward of mean(logits^2) in train mode: (loss, {name:
    grad}, state_dict keys, the generator's state after the step)."""
    cfg = ModelConfig(vocab_size=V, d_model=128, nhead=2, num_encoder_layers=2,
                      num_decoder_layers=2, d_ff=256, max_len=256, dropout=0.1, pos_dropout=0.1,
                      remat=remat, **PATHS[path])
    torch.manual_seed(0)
    model = ScoreTransformer(cfg)
    gen = torch.Generator().manual_seed(7)
    ta.reset_counts()
    ft.reset_counts()
    logits, _ = model(*_batch(), deterministic=False, generator=gen)
    loss = (logits.float() ** 2).mean()
    loss.backward()
    calls = (ta.dropout_attention_bwd_reference.calls, ft.flash_train_bwd_reference.calls)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return loss.item(), grads, list(model.state_dict()), gen.get_state(), calls


@pytest.mark.parametrize("path", list(PATHS))
def test_remat_gives_the_same_loss_gradients_and_generator_state(path):
    l0, g0, keys0, s0, calls0 = _step(path, remat=False)
    l1, g1, keys1, s1, calls1 = _step(path, remat=True)
    # the path took its kernels' twins (6 attentions a step at 2 + 2 layers)
    assert calls0 == calls1 == {"default": (0, 0), "fused_attn_train": (6, 0),
                                "flash_training": (0, 6)}[path]
    assert keys0 == keys1
    assert torch.equal(s0, s1)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert g0.keys() == g1.keys()
    for name in g0:
        np.testing.assert_allclose(g1[name].float().numpy(), g0[name].float().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_remat_recomputes_the_layers():
    """Under remat the forward twins run again in the backward pass (the
    recompute), and not at all more without gradients."""
    cfg = ModelConfig(vocab_size=V, d_model=128, nhead=2, num_encoder_layers=1,
                      num_decoder_layers=1, d_ff=256, max_len=256, dropout=0.0, pos_dropout=0.0,
                      flash_training=True, remat=True)
    model = ScoreTransformer(cfg)
    ft.reset_counts()
    with torch.no_grad():
        model(*_batch())
    assert ft.flash_train_fwd_reference.calls == 3
    ft.reset_counts()
    logits, _ = model(*_batch())
    logits.pow(2).mean().backward()
    assert (ft.flash_train_fwd_reference.calls, ft.flash_train_bwd_reference.calls) == (6, 3)
