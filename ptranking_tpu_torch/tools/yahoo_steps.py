"""Time two checkouts' training steps on one CUDA card.

    python3 -m ptranking_tpu_torch.tools.yahoo_steps [--flagship | --bf16 | --one-head] PARENT_DIR
        [CHANGE_DIR]

Runs `chip_smoke.yahoo_f32_steps` (LambdaRank steps of the Yahoo! LTR listsf
at d = 350 in fp32, in each bucket of 16 to 256 docs, with exact launch
counts and profiled card time) or, with --flagship, the flagship's fp32
steps (the F=136 DASALC listsf at d = 68, 32 lists of 1408 docs,
LambdaRank through the fused loss, Adagrad: `chip_smoke.timed_steps` of
`flagship_ranker(compute_dtype="float32")`, which chip_smoke.py has had
since the training slice) or, with --bf16, the bf16 flagship step (the same
model at its default bf16, `flagship_ranker()`) and the bf16 Yahoo! step at
d = 350 in each bucket of 16 to 256 docs (`WIDE_MODELS[0]`, `timed_steps`
with `wide_launches`) or, with --one-head, the one-head MSLR-WEB30K listsf
in fp32 (the flagship's F = 136, 6 layers, ff_dims (128, 256, 512), one head
of 136: `flagship_ranker(compute_dtype="float32", n_heads=1)`) at 32 lists
of 1408 docs, LambdaRank through the fused loss, with `wide_launches`'
counts (its attention past 256 docs at d > 128: the fp32 wide forward and
dk/dv and dq kernels) of PARENT_DIR, CHANGE_DIR, CHANGE_DIR and
PARENT_DIR in turn (CHANGE_DIR defaults to this checkout; PARENT_DIR is for
example a parent commit unpacked by `git archive`), each in a fresh Python
process that puts its checkout first on `sys.path` and builds that
checkout's kernels first, so that neither side's libraries, allocator or
caches reach the other's timings. Each step line a process prints comes out
with its turn and side in front ("P1", "C1", "C2", "P2"); a process that
fails stops the run with its exit code.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

# what each fresh process runs, with the checkout's directory as argv[1]
_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from ptranking_tpu_torch.ops import cuda_build
cuda_build.build(cuda_build.all_kernels())
chip_smoke.yahoo_f32_steps(chip_smoke.card_line())
"""
# with --flagship
_FLAGSHIP_CHILD = """
import json
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from ptranking_tpu_torch.ops import cuda_build
cuda_build.build(cuda_build.all_kernels())
card = cs.card_line()
rec = cs.timed_steps(cs.flagship_ranker(compute_dtype="float32"),
                     cs.train_batch(cs.TRAIN_B, cs.TRAIN_N, ragged=False, seed=2),
                     cs.TRAIN_STEPS, "fp32 flagship timed steps")
print("flagship_fp32_steps " + json.dumps(rec) + f"  [{card}]", flush=True)
"""

# with --one-head
_ONE_HEAD_CHILD = """
import json
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from ptranking_tpu_torch.ops import cuda_build
cuda_build.build(cuda_build.all_kernels())
card = cs.card_line()
B, N, F = 32, 1408, 136
ranker = cs.flagship_ranker(compute_dtype="float32", num_features=F, n_heads=1)
d = ranker.scorer_cfg.width
rec = cs.timed_steps(ranker, cs.train_batch(B, N, ragged=False, seed=2, num_features=F),
                     cs.TRAIN_STEPS, "one-head fp32 timed steps", cs.wide_launches(N, d, "float32"))
print("one_head_fp32_steps " + json.dumps({"head_dim": d, **rec}) + f"  [{card}]", flush=True)
"""

# with --bf16
_BF16_CHILD = """
import json
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from ptranking_tpu_torch.ops import cuda_build
cuda_build.build(cuda_build.all_kernels())
card = cs.card_line()
rec = cs.timed_steps(cs.flagship_ranker(), cs.train_batch(cs.TRAIN_B, cs.TRAIN_N, ragged=False,
                                                          seed=2),
                     cs.TRAIN_STEPS, "bf16 flagship timed steps")
print("flagship_bf16_steps " + json.dumps(rec) + f"  [{card}]", flush=True)
name, F, n_heads, lane_align, _ = cs.WIDE_MODELS[0]
ranker = cs.flagship_ranker(num_features=F, lane_align=lane_align, n_heads=n_heads)
d = ranker.scorer_cfg.width // n_heads
for N in cs.YAHOO_BUCKETS:
    batch = cs.train_batch(cs.YAHOO_DOCS // N, N, ragged=False, seed=2, num_features=F)
    rec = cs.timed_steps(ranker, batch, cs.YAHOO_STEPS, f"{name}_d{d} bf16 timed steps at {N} docs",
                         cs.wide_launches(N, d))
    print(f"{name}_d{d}_bf16_steps " + json.dumps({"head_dim": d, **rec}) + f"  [{card}]",
          flush=True)
"""


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    child = _CHILD
    if args[:1] == ["--flagship"]:
        child, args = _FLAGSHIP_CHILD, args[1:]
    elif args[:1] == ["--bf16"]:
        child, args = _BF16_CHILD, args[1:]
    elif args[:1] == ["--one-head"]:
        child, args = _ONE_HEAD_CHILD, args[1:]
    if not 1 <= len(args) <= 2:
        print("\n".join(__doc__.strip().splitlines()[2:4]), file=sys.stderr)
        return 2
    parent = Path(args[0]).resolve()
    change = Path(args[1]).resolve() if len(args) == 2 else Path(__file__).resolve().parents[2]
    for turn, side, root in (("P1", "parent", parent), ("C1", "change", change),
                             ("C2", "change", change), ("P2", "parent", parent)):
        if not (root / "chip_smoke.py").exists():
            print(f"yahoo_steps: no chip_smoke.py in {root}", file=sys.stderr)
            return 2
        proc = subprocess.run([sys.executable, "-c", child, str(root)], cwd=root,
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if "_steps " in line or line.startswith("NVIDIA"):
                print(f"{turn} {side} {line}", flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
