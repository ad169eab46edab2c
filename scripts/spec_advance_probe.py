"""Where `spec_advance_kernel`'s time goes: a stage breakdown by clock64()
stamps, taken on a patched copy of the kernel's source (the shipped kernel
carries no probe).

The script runs the port of a checkout (``--root``, by default this one;
an unpacked ``git archive`` of another commit's ``chip_smoke.py`` and
``smer_music_generation_tpu_torch/`` will do, its ``assets`` linked), copies
its ``ops/csrc`` to ``build/spec_advance_probe/<tag>/``,
inserts into ``decode_token.cu`` a ``__device__`` array of per-stage cycle
sums and, after each stage of the kernel (found by text anchors in the
source; the script stops if one does not match), a stamp by thread 0:
clock64() minus the last stamp, added to the stage's sum.  Stamps follow a block barrier, so
a stage is the block's time from one barrier to the next.  Only sampling
iterations of the W-slot window count (not the prime, not the W = 1 tail,
not an iteration past the end).  It builds that copy into its own library
(the port's build, pointed at the copy), then on the card:

- decodes one speculative request as phase 2k of ``chip_smoke.py`` does
  (the random flagship, vocab_mode 0, nucleus 0.9 and greedy, draft_k 8,
  max_tgt_len 1024, a 1536-id source), one CUDA-graph replay an iteration:
  the stages in a replay (the wait stage holds the overlap with the logits
  launch, a programmatic dependent launch);
- launches the kernel alone (``ops.decode_step.spec_advance``) 50 times on
  a recorded iteration's inputs: the stages alone (the shipped kernel's
  device time alone is phase 2k's);
- times the draft tables' reset once a decode (``SpecGraph.tables_reset``,
  CUDA events).

Each stage is printed in cycles and in µs at the SM clock nvidia-smi reads
after the run, with the card's name and power limit.  Run on the card:
``python3 scripts/spec_advance_probe.py [--root build/parent --tag parent]``
(~30 s with its build).  Writes the readings as JSON to ``--out`` (by default
``build/spec_advance_probe.json``).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def _root() -> Path:
    """--root, read before the port is imported: the checkout whose port
    (and chip_smoke.py, for its helpers) the probe runs."""
    for i, arg in enumerate(sys.argv):
        if arg == "--root" and i + 1 < len(sys.argv):
            return Path(sys.argv[i + 1]).resolve()
        if arg.startswith("--root="):
            return Path(arg.split("=", 1)[1]).resolve()
    return REPO


sys.path.insert(0, str(_root()))

import chip_smoke as cs  # noqa: E402
from smer_music_generation_tpu_torch.infer import decode as decode_mod  # noqa: E402
from smer_music_generation_tpu_torch.infer.decode import InfillDecoder  # noqa: E402
from smer_music_generation_tpu_torch.ops import decode_graph as dg  # noqa: E402
from smer_music_generation_tpu_torch.ops import decode_step as ds  # noqa: E402

HEADER = r"""
__device__ unsigned long long g_spec_probe[32];  // [0] launches, [1 + i] stage i's cycles
extern "C" int smer_spec_probe_read(void* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_spec_probe, sizeof(g_spec_probe));
  if (e == cudaSuccess && reset) {
    unsigned long long z[32] = {};
    e = cudaMemcpyToSymbol(g_spec_probe, z, sizeof(z));
  }
  return (int)e;
}
#define SPEC_PROBE_BEGIN                                                                  \
  const bool probe_on_ = a.W > 1 && !a.prime && a.carry[1] == 0 && a.carry[0] + a.W < a.L; \
  long long probe_t_ = clock64();                                                         \
  if (probe_on_ && threadIdx.x == 0) atomicAdd(&g_spec_probe[0], 1ull);
#define SPEC_PROBE(i)                                                                     \
  if (probe_on_ && threadIdx.x == 0) {                                                    \
    const long long t_ = clock64();                                                       \
    atomicAdd(&g_spec_probe[1 + (i)], (unsigned long long)(t_ - probe_t_));               \
    probe_t_ = t_;                                                                        \
  }
// inside one slot's sampling: slot 0 of a W > 1 window, its warp's lane 0;
// [24] counts the slot's ends that reach the last stamp
#define SPEC_SLOT_BEGIN                                                                   \
  const bool slot_on_ = a.W > 1 && j == 0 && threadIdx.x == 0;                            \
  long long slot_t_ = clock64();
#define SPEC_SLOT(i)                                                                      \
  if (slot_on_) {                                                                         \
    const long long t_ = clock64();                                                       \
    atomicAdd(&g_spec_probe[17 + (i)], (unsigned long long)(t_ - slot_t_));               \
    slot_t_ = t_;                                                                         \
  }
#define SPEC_SLOT_END(i)                                                                  \
  SPEC_SLOT(i)                                                                            \
  if (slot_on_) atomicAdd(&g_spec_probe[24], 1ull);
"""

WAIT = '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
# the kernel's stages: (name, anchor, the text after which the stamp goes
# (None: the whole anchor), the stamp), in the kernel's order; the first
# entry opens the kernel
STAGES = [
    ("begin", "spec_advance_kernel(const SpecArgs a) {\n", None, "  SPEC_PROBE_BEGIN\n"),
    ("stage the window, the 16 x (W - 1) transitions and sid_tbl",
     "    __threadfence();\n  }\n  __syncthreads();\n", None, "  SPEC_PROBE(0)\n"),
    ("each warp's chain, its slot's mask and noise loads, griddepcontrol.wait",
     WAIT + "  if (active) {\n    for (int j = warp; j < W; j += kSpecWarps) {\n", WAIT,
     "  SPEC_PROBE(1)\n"),
    ("the slots' tokens and bookkeeping (a warp a slot)",
     "        npost_s[j] = new_span;\n      }\n    }\n  }\n  __syncthreads();\n", None,
     "  SPEC_PROBE(2)\n"),
    ("warp 0: prefix by ballot, carry, out, kv_rows, the draft's table lookup and inserts",
     "      p_s = P;\n    }\n  }\n  __syncthreads();\n", None, "  SPEC_PROBE(3)\n"),
    ("the W x D input rows (float4)",
     "    *reinterpret_cast<float4*>(a.x + (size_t)j * a.D + l) = v;\n  }\n", None,
     "  __syncthreads();\n  SPEC_PROBE(4)\n"),
]
# inside the slots' stage: slot 0's sampling by its warp (lane 0's clock),
# stamped as STAGES are
SLOT_STAGES = [
    ("begin", "float u, int draft, float* seg, int lane) {\n", None, "  SPEC_SLOT_BEGIN\n"),
    ("its logits (through L2), masked over the temperature, their max", "  mx = warp_max(mx);\n", None,
     "  SPEC_SLOT(0)\n"),
    ("the log-softmax's sum and log", "  const float ls = logf(s);\n", None, "  SPEC_SLOT(1)\n"),
    ("the nucleus rule (compaction, the mass above each kept probability)",
     "      if (!(above < a.nucleus_p)) logp[i] = kNeg;\n    }\n", None, "    SPEC_SLOT(2)\n"),
    ("the draft's acceptance probability",
     "    const float p_draft = expf(__shfl_sync(kFull, mine, d & 31)) / fmaxf(norm, 1e-38f);\n", None,
     "    SPEC_SLOT(3)\n"),
    ("the residual's argmax (slots whose draft is refused)",
     "      bi = v;\n    }\n  }\n  return warp_argmax(best, bi);\n}\n", "      bi = v;\n    }\n  }\n",
     "  SPEC_SLOT_END(4)\n"),
]


def patch(src: str):
    """The source with the probe; raises unless every anchor of STAGES and
    SLOT_STAGES matches once."""
    missing = [name for name, anchor, _, _ in STAGES + SLOT_STAGES if src.count(anchor) != 1]
    if missing:
        raise SystemExit(f"decode_token.cu does not match the probe's anchors of {missing}")
    head = src.index("namespace {")
    src = src[:head] + HEADER + src[head:]
    for _, anchor, after, stamp in STAGES + SLOT_STAGES:
        after = anchor if after is None else after
        src = src.replace(anchor, anchor.replace(after, after + stamp, 1))
    return src


def build(root: Path, tag: str):
    """The patched copy of ``root``'s csrc, built into its own library, bound
    in place of the port's (``ds.load_library`` returns it).  The copy's
    library directory is kept between runs, so an unchanged patched source
    is served by ``load_library``'s cache."""
    dst = REPO / "build" / "spec_advance_probe" / tag
    if (dst / "csrc").exists():
        shutil.rmtree(dst / "csrc")
    shutil.copytree(root / "smer_music_generation_tpu_torch" / "ops" / "csrc", dst / "csrc")
    f = dst / "csrc" / "decode_token.cu"
    f.write_text(patch(f.read_text()))
    ds._CSRC = dst / "csrc"
    ds._SOURCES = tuple(dst / "csrc" / p.name for p in ds._SOURCES)
    ds._BUILD_DIR = dst / "lib"
    ds._lib = None
    lib = ds.load_library()
    lib.smer_spec_probe_read.argtypes = [ds.ctypes.c_void_p, ds.ctypes.c_int]
    lib.smer_spec_probe_read.restype = ds.ctypes.c_int
    return lib


def read(lib, reset: bool = True):
    torch.cuda.synchronize()
    buf = (ds.ctypes.c_ulonglong * 32)()
    ds._check(lib.smer_spec_probe_read(ds.ctypes.addressof(buf), int(reset)), "spec probe read")
    return int(buf[0]), [int(x) for x in buf[1:]]


def say_stages(label, n, cycles, stages, mhz, slot_stages=()):
    total = sum(cycles[:len(stages)])
    cs.say(f"  {label}: {n} launches; {total / max(n, 1):.0f} cycles a launch "
           f"({total / max(n, 1) / mhz:.3f} us at {mhz:.0f} MHz)")
    out = {}
    for i, name in enumerate(stages):
        c = cycles[i] / max(n, 1)
        out[name] = dict(cycles=c, us=c / mhz)
        cs.say(f"    {i}. {name}: {c:.0f} cycles, {c / mhz:.3f} us ({100 * cycles[i] / max(total, 1):.1f}%)")
    ends = cycles[23]  # the slot-0 samplings that reached the residual's argmax
    for i, name in enumerate(slot_stages):
        k = ends if i == len(slot_stages) - 1 else n
        c = cycles[16 + i] / max(k, 1)
        out[f"slot 0: {name}"] = dict(cycles=c, us=c / mhz, count=k)
        cs.say(f"      slot 0, {name}: {c:.0f} cycles, {c / mhz:.3f} us (over {k} samplings)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO), help="the checkout whose kernel to probe")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=str(REPO / "build" / "spec_advance_probe.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spec_advance_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.say(f"card: {card}; probing {args.root}")
    lib = build(Path(args.root), args.tag)
    cs.say(f"  built {ds.BUILD_INFO['path']} in {ds.BUILD_INFO['seconds']:.1f} s")
    stages = [name for name, _, _, _ in STAGES[1:]]
    slot_stages = [name for name, _, _, _ in SLOT_STAGES[1:]]
    vocab, model, _, vpad = cs.random_flagship(dev)
    result = dict(card=card, root=args.root, runs={})
    for greedy in (False, True):
        rng = np.random.default_rng(11)
        asm = cs.spec_request(rng, vocab, 1536, 4)
        kw = dict(max_tgt_len=cs.L, greedy=greedy, nucleus_p=None if greedy else 0.9, draft_k=cs.SPEC_K,
                  seed=5)
        label = "greedy" if greedy else "nucleus"
        dec = InfillDecoder(model, vocab, fused=True, **kw)
        dec(*asm)  # the capture and a first decode
        read(lib)
        got = dec(*asm)
        n, cyc = read(lib)
        mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                                   capture_output=True, text=True, check=True).stdout.split()[0])
        run = dict(positions=got.steps, sm_mhz=mhz)
        run["replayed"] = say_stages(f"{label}, replayed iterations (W={cs.SPEC_K + 1})", n, cyc, stages, mhz,
                                     slot_stages)
        run["tables_reset_ms"] = cs.cuda_ms(cs.spec_graph_of(dec).tables_reset, iters=20)
        cs.say(f"    the draft tables' reset, once a decode: {1e3 * run['tables_reset_ms']:.2f} us (events)")
        rec = cs.SpecRecorder(limit=40)
        with mock.patch.object(decode_mod, "open_spec_graph", lambda *a, **k: dg.open_spec_graph(
                *a, **{**k, "graph": False})), \
                mock.patch.object(dg.SpecGraph, "_advance", lambda g, *a, **k: rec(g, *a, **k)):
            InfillDecoder(model, vocab, fused=True, **kw)(*asm)
        window = next(r for r in rec.records if r[1][2].shape[0] == cs.SPEC_K + 1)
        eager = window[0]
        read(lib)
        _, (carry, out, win, logits), _ = window
        args_ = (logits, carry, out, win, eager.src, eager.span_types, eager.aux, eager.tables,
                 eager.fast_tables, eager.noise, eager.uniforms, eager.emb, eager.pos_table)
        for _ in range(50):
            ds.spec_advance(*args_, compute_dtype=eager.cdt, **eager.skw)
        n, cyc = read(lib)
        run["alone"] = say_stages(f"{label}, alone on a recorded iteration", n, cyc, stages, mhz, slot_stages)
        result["runs"][label] = run
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    cs.say(f"  wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
