"""The PyTorch port imports nothing of JAX, flax, msgpack or the JAX package.

The test process itself has JAX loaded (``tests/conftest.py`` imports it),
so the check runs in a subprocess whose ``sys.meta_path`` refuses those
packages: it imports every module of the port and ``chip_smoke`` (without
running it), then decodes a few tokens with a tiny model on the CPU.
"""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "smer_music_generation_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "ml_dtypes",
           "smer_music_generation_tpu")

CHILD = r"""
import importlib, importlib.abc, pathlib, sys

BLOCKED = %r

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
root = pathlib.Path(%r)
sys.path.insert(0, str(root))
mods = sorted(
    ".".join(p.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
    for p in (root / "smer_music_generation_tpu_torch").rglob("*.py")
)
for m in mods + ["chip_smoke"]:
    importlib.import_module(m)

import numpy as np
import torch
from smer_music_generation_tpu_torch.infer.decode import InfillDecoder, pad_to_bucket
from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.vocab import CONTROL_SETS, WordVocab

vocab = WordVocab(0, CONTROL_SETS[5])
torch.manual_seed(0)
model = ScoreTransformer(ModelConfig(vocab_size=vocab.vocab_size, d_model=64, nhead=1,
                                     num_encoder_layers=1, num_decoder_layers=1, d_ff=64))
toks = ["4/4", "t_3", "k_0", "d_2", "o_2", "y_2", "i_0", "bar", "s_2", "track_0",
        "d_2", "o_2", "y_2", "m_0", "m_0", "m_0", "m_0"]
src = pad_to_bucket(np.array([[vocab.char2index(t) for t in toks]], np.int32), bucket=32)
span_types = np.zeros((1, 8), np.int32)
span_types[0, :4] = [0, 1, 2, 3]
for fused in (False, True):
    dec = InfillDecoder(model.eval(), vocab, max_tgt_len=64, max_spans=8, span_cap=10,
                        greedy=True, nucleus_p=None, fused=fused)
    out = dec(src, span_types, np.array([4]), False)
    assert int(out.lengths[0]) > 4, out
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok", len(mods))
"""


def test_port_imports_without_jax_and_decodes():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD % (BLOCKED, str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT), env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")


def test_port_sources_name_no_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|msgpack|ml_dtypes|"
        r"smer_music_generation_tpu)\b", re.M,
    )
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_not_implemented_errors_name_existing_roadmap_items():
    """No ``NotImplementedError`` is left to name a ROADMAP item: the port
    does all that JAX does, and no source of it raises (or names) one.  The
    last, the attention kernels' refusal of a head_dim above 128, went with
    the wide kernels (``ops/attention_wide.py``)."""
    files = list(PORT.rglob("*.py"))
    assert len(files) > 20
    offenders = [str(f) for f in files if "NotImplementedError" in f.read_text()]
    assert not offenders, offenders
