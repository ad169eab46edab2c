"""The check for JAX in the process compares whole top-level names."""

import sys
import types

from port_bench import harness


def test_top_level_names_compared_whole(monkeypatch):
    for name in ("smer_music_generation_tpu_torch.vocab", "jaxtyping", "flaxx"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == [m for m in harness.forbidden_modules()
                                           if m.split(".")[0] in harness.FORBIDDEN]
    for name in ("smer_music_generation_tpu_torch.vocab", "jaxtyping", "flaxx"):
        assert name not in harness.forbidden_modules()
    for name in ("jax", "jax.numpy", "flax.linen", "jaxlib", "smer_music_generation_tpu.vocab"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert name in harness.forbidden_modules()


def test_harness_and_program_load_no_jax():
    import subprocess

    code = ("import sys; sys.path.insert(0, '.'); import port_bench.run, port_bench.calibrate; "
            "from port_bench import harness, serving; "
            "import port_bench.traffic.batch, port_bench.traffic.single, port_bench.traffic.train; "
            "import smer_music_generation_tpu_torch.serve.app, smer_music_generation_tpu_torch.train.state; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(harness.ROOT), check=True)
    assert out.stdout.strip() == "[]"
