"""Convert reference PyTorch checkpoints into the port's checkpoints.

Port of ``smer_music_generation_tpu/train/convert.py``: ``infer_config``
(:86), ``torch_state_dict_to_params`` (:115), ``load_torch_checkpoint``
(:159) and the CLI ``main`` (:180).  The reference trains with torch and
saves ``{'model_state_dict', 'optimizer_state_dict', 'epoch', 'loss'}`` an
epoch; a user migrating from it brings such a file.  Here the mapping is a
rename of its state-dict keys onto the port's ``ScoreTransformer`` names
(torch's (out, in) ``Linear.weight`` is the port's layout, so nothing
transposes):

  embedding.weight                                -> embedding.weight
  fc.{weight,bias}                                -> fc.{weight,bias}
  transformer.encoder.layers.{i}.self_attn.*      -> encoder_layers.{i}.self_attn.{q,k,v,out}
  transformer.encoder.layers.{i}.linear{1,2}.*    -> encoder_layers.{i}.ff.fc{1,2}
  transformer.encoder.layers.{i}.norm{1,2}.*      -> encoder_layers.{i}.norm{1,2}
  transformer.encoder.norm.*                      -> norm_e   (final LN)
  transformer.decoder.layers.{i}.self_attn.*      -> decoder_layers.{i}.self_attn
  transformer.decoder.layers.{i}.multihead_attn.* -> decoder_layers.{i}.cross_attn
  transformer.decoder.layers.{i}.linear{1,2}.*    -> decoder_layers.{i}.ff.fc{1,2}
  transformer.decoder.layers.{i}.norm{1,2,3}.*    -> decoder_layers.{i}.norm{1,2,3}
  transformer.decoder.norm.*                      -> norm_d   (final LN)

``MultiheadAttention.in_proj_weight`` is the (3D, D) concatenation of the
q, k and v projections.  The optimizer state is not converted: the written
checkpoint carries a fresh Adam, with the payload's epoch and loss.

    python -m smer_music_generation_tpu_torch.train.convert <ckpt> <out_dir> [--nhead N] [--max-len N]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..models.transformer import ModelConfig


def _t(x: Any) -> torch.Tensor:
    """A tensor or array-like -> a contiguous f32 CPU tensor of its own."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32).clone().contiguous()


def _linear(sd: Mapping[str, Any], src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {f"{dst}.weight": _t(sd[f"{src}.weight"]), f"{dst}.bias": _t(sd[f"{src}.bias"])}


def _attention(sd: Mapping[str, Any], src: str, dst: str) -> Dict[str, torch.Tensor]:
    w = _t(sd[f"{src}.in_proj_weight"])  # (3D, D)
    b = _t(sd[f"{src}.in_proj_bias"])
    d = w.shape[1]
    out = {}
    for i, name in enumerate(("q", "k", "v")):
        out[f"{dst}.{name}.weight"] = w[i * d : (i + 1) * d].clone()
        out[f"{dst}.{name}.bias"] = b[i * d : (i + 1) * d].clone()
    out.update(_linear(sd, f"{src}.out_proj", f"{dst}.out"))
    return out


def _count_layers(sd: Mapping[str, Any], stack: str) -> int:
    n = 0
    while f"transformer.{stack}.layers.{n}.norm1.weight" in sd:
        n += 1
    return n


def infer_config(sd: Mapping[str, Any], nhead: Optional[int] = None, max_len: int = 2400,
                 dtype: torch.dtype = torch.float32) -> ModelConfig:
    """The architecture from the checkpoint's shapes (JAX :86).  ``nhead``
    cannot be read from shapes; the default is the reference's 64-wide heads
    (d512 -> 8, d256 -> 4)."""
    vocab_size, d_model = _t(sd["embedding.weight"]).shape
    d_ff = _t(sd["transformer.encoder.layers.0.linear1.weight"]).shape[0]
    return ModelConfig(
        vocab_size=int(vocab_size),
        d_model=int(d_model),
        nhead=int(nhead) if nhead else max(1, d_model // 64),
        num_encoder_layers=_count_layers(sd, "encoder"),
        num_decoder_layers=_count_layers(sd, "decoder"),
        d_ff=int(d_ff),
        max_len=max_len,
        dtype=dtype,
        final_norm="transformer.decoder.norm.weight" in sd,
    )


def torch_state_dict_to_params(sd: Mapping[str, Any], cfg: Optional[ModelConfig] = None
                               ) -> Tuple[ModelConfig, Dict[str, torch.Tensor]]:
    """A reference ``model_state_dict`` -> ``(cfg, state dict)`` for the
    port's ``ScoreTransformer(cfg).load_state_dict`` (JAX :115)."""
    if cfg is None:
        cfg = infer_config(sd)
    out: Dict[str, torch.Tensor] = {"embedding.weight": _t(sd["embedding.weight"])}
    out.update(_linear(sd, "fc", "fc"))
    for stack, n, attns, norms in (
        ("encoder", cfg.num_encoder_layers, (("self_attn", "self_attn"),), 2),
        ("decoder", cfg.num_decoder_layers,
         (("self_attn", "self_attn"), ("multihead_attn", "cross_attn")), 3),
    ):
        for i in range(n):
            src, dst = f"transformer.{stack}.layers.{i}", f"{stack}_layers.{i}"
            for a_src, a_dst in attns:
                out.update(_attention(sd, f"{src}.{a_src}", f"{dst}.{a_dst}"))
            for j in (1, 2):
                out.update(_linear(sd, f"{src}.linear{j}", f"{dst}.ff.fc{j}"))
            for j in range(1, norms + 1):
                out.update(_linear(sd, f"{src}.norm{j}", f"{dst}.norm{j}"))
    if cfg.final_norm:
        out.update(_linear(sd, "transformer.encoder.norm", "norm_e"))
        out.update(_linear(sd, "transformer.decoder.norm", "norm_d"))
    return cfg, out


def load_torch_checkpoint(path: str, nhead: Optional[int] = None, max_len: int = 2400,
                          dtype: torch.dtype = torch.float32
                          ) -> Tuple[ModelConfig, Dict[str, torch.Tensor], Dict[str, Any]]:
    """Load a reference ``torch.save`` file (JAX :159): the training payload
    ``{'model_state_dict': ...}`` or a bare state dict.  Returns ``(cfg,
    state dict, meta)``, meta holding the epoch and loss where present."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload.get("model_state_dict", payload)
    meta = {k: payload[k] for k in ("epoch", "loss") if k in payload}
    cfg = infer_config(sd, nhead=nhead, max_len=max_len, dtype=dtype)
    cfg, params = torch_state_dict_to_params(sd, cfg)
    return cfg, params, meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert a reference torch checkpoint into a checkpoint of the port's trainer "
        "(<out_dir>/checkpoint_<epoch>/state.pt).")
    ap.add_argument("checkpoint", help="reference torch checkpoint (.pt/.pth)")
    ap.add_argument("out_dir", help="output directory for the port's checkpoint")
    ap.add_argument("--nhead", type=int, default=None, help="attention heads (default: d_model // 64)")
    ap.add_argument("--max-len", type=int, default=2400)
    args = ap.parse_args(argv)

    from ..models.transformer import ScoreTransformer
    from .checkpoint import save_checkpoint
    from .state import TrainState

    cfg, params, meta = load_torch_checkpoint(args.checkpoint, nhead=args.nhead,
                                              max_len=args.max_len)
    model = ScoreTransformer(cfg)
    model.load_state_dict(params)
    state = TrainState.create(model, lr=1e-4)
    path = save_checkpoint(args.out_dir, int(meta.get("epoch", 0)), state,
                           float(meta.get("loss", 0.0)))
    print(
        f"converted {args.checkpoint} -> {path} "
        f"(d_model={cfg.d_model}, nhead={cfg.nhead}, "
        f"layers={cfg.num_encoder_layers}+{cfg.num_decoder_layers}, "
        f"vocab={cfg.vocab_size}, final_norm={cfg.final_norm})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
