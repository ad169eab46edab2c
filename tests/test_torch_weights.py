"""The port's weight loading: its own flax-msgpack reader and the flax ->
torch parameter mapping, checked against flax itself."""

import json

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.train.state import (
    check_sidecar,
    default_flagship_snapshot,
    load_inference_model,
    params_from_flax,
    read_flax_msgpack,
)
from smer_music_generation_tpu_torch.utils.config import ExperimentConfig
from tests.torch_port_helpers import flax_from_params, model_pair

ASSETS = ["assets/flagship_params.msgpack", "assets/flagship_remi_params.msgpack"]


def _assert_bit_equal(ours, theirs, path="") -> int:
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and ours.keys() == theirs.keys(), path
        return sum(_assert_bit_equal(ours[k], theirs[k], f"{path}/{k}") for k in theirs)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, path
    assert ours.itemsize == theirs.itemsize, path
    assert ours.tobytes() == theirs.tobytes(), path
    return 1


@pytest.mark.parametrize("path", ASSETS)
def test_reader_bit_equal_to_flax(path):
    with open(path, "rb") as fh:
        want = serialization.msgpack_restore(fh.read())
    got = read_flax_msgpack(path)
    assert _assert_bit_equal(got, want) == 175  # every leaf of the 4+4 model


def test_params_from_flax_round_trips():
    vocab = WordVocab(0, CONTROL_SETS[5])
    _, params, tmodel = model_pair(vocab.vocab_size, seed=3)
    tree = jax.tree.map(np.asarray, params)
    state = params_from_flax(tree)
    assert set(state) == set(tmodel.state_dict())
    back = flax_from_params(state)
    assert _assert_bit_equal(back, tree) == len(state)
    # Dense kernels are (in, out) in flax and (out, in) in torch
    k = tree["params"]["decoder_0"]["ff"]["fc1"]["kernel"]
    assert torch.equal(state["decoder_layers.0.ff.fc1.weight"], torch.from_numpy(k.T.copy()))


def test_snapshot_loads_with_bf16_values():
    path = default_flagship_snapshot()
    vocab = WordVocab(0, CONTROL_SETS[5])
    model, epoch = load_inference_model(
        ExperimentConfig(), vocab.vocab_size, path, torch.float32, device="cpu"
    )
    raw = read_flax_msgpack(path)["params"]["embedding"]["embedding"]
    assert raw.dtype == np.uint16  # bf16 bits
    want = torch.from_numpy(raw.copy()).view(torch.bfloat16).float()
    assert torch.equal(model.embedding.weight, want)
    assert epoch == 17 and model.norm_d is not None


def test_sidecar_mismatch_raises(tmp_path):
    meta = json.load(open(ASSETS[1] + ".json"))
    with pytest.raises(ValueError, match="vocab_size=349"):
        check_sidecar(meta, vocab_size=309, vocab_mode=0, path=ASSETS[1])
    check_sidecar(meta, vocab_size=349, vocab_mode=1)
    vocab = WordVocab(0, CONTROL_SETS[5])
    with pytest.raises(ValueError, match="vocab"):
        load_inference_model(ExperimentConfig(), vocab.vocab_size, ASSETS[1],
                             torch.float32, device="cpu")


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_inference_model(ExperimentConfig(), 309, None, torch.bfloat16, device="cuda")
