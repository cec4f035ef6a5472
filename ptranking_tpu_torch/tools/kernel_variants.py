"""Time design variants of the hand-written kernels on one CUDA card.

    python3 -m ptranking_tpu_torch.tools.kernel_variants [library ...]

For each library named (by default all of those in VARIANTS: the bf16
flash-attention backward and forward, and the Sinkhorn half-step), builds the
shipped `ops/csrc/<library>.cu` and copies of it with one knob turned or one
phase cut out (text substitutions, each asserted to match), and for the
backward the warpgroup experiment `ops/csrc/experiments/flash_attn_bwd_wgmma.cu`,
all with nvcc started together. Then it times each variant's kernels, once in
the listed order and once in reverse: the backward's dk/dv and dq at the
training shape (32, 2, 1408, 68) bf16; the forward with row statistics at that
shape and at the one-list serving shape (1, 2, 1536, 68); the half-step over
rows and over columns at 32 x 1408 x 1408 fp32. It prints one JSON line per
variant: registers and spill bytes of the kernels in question, the two times
of each case in ms (CUDA events, the median of three blocks of calls), and
whether the outputs equal the shipped kernels' bit for bit, with the largest
difference (a design variant may round otherwise; a variant with a phase cut
out cannot agree, it shows what the phase costs).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ptranking_tpu_torch.ops import attention, cuda_build

ITERS = 20
ATTN_SHAPE = (32, 2, 1408, 68)
FWD_SHAPES = [ATTN_SHAPE, (1, 2, 1536, 68)]
SINK_SHAPE = (32, 1408)
EXPERIMENT = cuda_build.CSRC / "experiments" / "flash_attn_bwd_wgmma.cu"

_BLOCKS = "return kc <= 5 ? 3 : 2;"
_MORE = "const bool more = t + 1 < tiles;"
_WARPS = "constexpr int MMA_WARPS = 4;"
_CUT_COPIES = [(_MORE, _MORE.replace(";", " && N < 0;"))]

# The backward: warps a block (rows a block owns = 16 x warps) with the blocks
# an SM the register budget is cut for, and the columns of S / dP held at a
# time; then no copies of the next tile (both kernels), half of them, all of
# them from one cache-hot tile; in the dk/dv kernel no softmax arithmetic, no
# second products; and the warpgroup experiment, a source of its own.
_BWD_SUB = "constexpr int SUB = 32;"
_BWD_NO_SOFTMAX = [
    ("const float x0 = real ? s[j][2 * h] * scale : MASKED_LOGIT;", "const float x0 = s[j][2 * h];"),
    ("const float x1 = real ? s[j][2 * h + 1] * scale : MASKED_LOGIT;",
     "const float x1 = s[j][2 * h + 1];"),
    ("const float p0 = in ? __expf(x0 - m2.x) * inv2.x : 0.f;", "const float p0 = x0;"),
    ("const float p1 = in ? __expf(x1 - m2.y) * inv2.y : 0.f;", "const float p1 = x1;"),
    ("const float ds0 = real ? p0 * (dp[j][2 * h] - D2.x) : 0.f;", "const float ds0 = dp[j][2 * h];"),
    ("const float ds1 = real ? p1 * (dp[j][2 * h + 1] - D2.y) : 0.f;",
     "const float ds1 = dp[j][2 * h + 1];"),
]
BWD_VARIANTS = {
    "shipped": [],
    "warps6_blocks2": [(_WARPS, _WARPS.replace("4", "6")), (_BLOCKS, "return kc <= 5 ? 2 : 1;")],
    "warps8_blocks1": [(_WARPS, _WARPS.replace("4", "8")), (_BLOCKS, "return 1;")],
    "warps12_blocks1": [(_WARPS, _WARPS.replace("4", "12")), (_BLOCKS, "return 1;")],
    "sub16": [(_BWD_SUB, _BWD_SUB.replace("32", "16"))],
    "sub64_blocks2": [(_BWD_SUB, _BWD_SUB.replace("32", "64")), (_BLOCKS, "return 2;")],
    "blocks2": [(_BLOCKS, "return 2;")],
    "cut_copies": _CUT_COPIES,
    # only q (dk/dv kernel) and k (dq kernel) are copied in the loop
    "half_copies": [
        ("            load_tile<MMA_NT, KC, TILE>(dOs + (buf ^ 1) * TILE_ELEMS, dout + base + "
         "size_t(q1) * d,\n                                        nrows, d, copy_8b, magic);\n", ""),
        ("            load_tile<MMA_NT, KC, TILE>(Vs + (buf ^ 1) * TILE_ELEMS, v + base + "
         "size_t(k1) * d,\n                                        nrows, d, copy_8b, magic);\n", "")],
    "hot_copies": [("q + base + size_t(q1) * d", "q + base"),
                   ("dout + base + size_t(q1) * d", "dout + base"),
                   ("k + base + size_t(k1) * d", "k + base"), ("v + base + size_t(k1) * d", "v + base")],
    "cut_softmax": _BWD_NO_SOFTMAX,
    "cut_second_products": [
        ("product_kn<KC, SUB / 16>(acc_v, pa, dOt, sub, lane);",
         "acc_v[0][0] += __uint_as_float(pa[0][0] ^ pa[1][3]);"),
        ("product_kn<KC, SUB / 16>(acc_k, dsa, Qt, sub, lane);",
         "acc_k[0][0] += __uint_as_float(dsa[0][0] ^ dsa[1][3]);")],
    "cut_copies_and_softmax": [*_CUT_COPIES, *_BWD_NO_SOFTMAX],
    "wgmma_experiment": EXPERIMENT,
}

# The forward: keys of S a warp holds at a time, blocks an SM the registers
# are cut for, 8 warps owning 128 query rows; then without the next tile's
# copies, with every copy from the first tile (the same instructions,
# cache-hot data), without its exponentials (p = x - m), without the P V
# product.
_FWD_SUB = "constexpr int SUB = 64;"
FWD_VARIANTS = {
    "shipped": [],
    "sub32": [(_FWD_SUB, _FWD_SUB.replace("64", "32"))],
    "blocks2": [(_BLOCKS, "return 2;")],
    "blocks4": [(_BLOCKS, "return kc <= 5 ? 4 : 2;")],
    "warps8_blocks1": [(_WARPS, _WARPS.replace("4", "8")), (_BLOCKS, "return 1;")],
    "cut_copies": _CUT_COPIES,
    "hot_copies": [("k + base + size_t(k1) * d", "k + base"),
                   ("v + base + size_t(k1) * d", "v + base")],
    "cut_exp": [("const float p0 = ex2(s[j][2 * h] - m[h]);", "const float p0 = s[j][2 * h] - m[h];"),
                ("const float p1 = ex2(s[j][2 * h + 1] - m[h]);",
                 "const float p1 = s[j][2 * h + 1] - m[h];")],
    "cut_pv": [("product_kn<KC, SUB / 16>(acc, pa, Vt, sub, lane);",
                "acc[0][0] += __uint_as_float(pa[0][0] ^ pa[SUB / 16 - 1][3]);")],
}

# The half-step: lanes across a row of the column kernel, float4 loads in
# flight a thread, the compiler's division everywhere instead of the FMA one;
# then a multiplication by 1/lam for the division, no per-element exp, and
# every load from one cache-hot row (the instructions stay, the device-memory
# traffic goes).
_LANES = "constexpr int VEC_LANES = 32;"
_CHUNK = "constexpr int CHUNK = 4;"
SINK_VARIANTS = {
    "shipped": [],
    "lanes16": [(_LANES, _LANES.replace("32", "16"))],
    "chunk2": [(_CHUNK, _CHUNK.replace("4", "2"))],
    "true_div": [("bool ok = lam_ordinary;", "bool ok = false;")],
    "cut_div": [("if (!FAST) return -c / lam;", "if (true) return -c * y;")],
    "cut_exp": [("for (int u = 0; u < U; ++u) s += expf(x[u] - mc);",
                 "for (int u = 0; u < U; ++u) s += x[u] - mc;")],
    "hot_loads": [("*reinterpret_cast<const float4*>(cb + size_t(i + r * VEC_SLOTS) * N)",
                   "*reinterpret_cast<const float4*>(cb + size_t(r * VEC_SLOTS) * N)"),
                  ("*reinterpret_cast<const float4*>(row + j + 128 * r)",
                   "*reinterpret_cast<const float4*>(row + 128 * r)")],
}

# library -> {variant: substitutions in the shipped source, or a source of its own}
VARIANTS = {"flash_attn_bwd": BWD_VARIANTS, "flash_attn_fwd": FWD_VARIANTS,
            "sinkstep": SINK_VARIANTS}
# the kernels whose registers and spills each library's lines report
_REPORTED = {"flash_attn_bwd": [r"flash_bwd_dkdv_mma_kernelILi5E", r"flash_bwd_dq_mma_kernelILi5E",
                                r"flash_bwd_dkdv_wgmma_kernel", r"flash_bwd_dq_wgmma_kernel"],
             "flash_attn_fwd": [r"flash_fwd_mma_kernelILi5E"],
             "sinkstep": [r"sinkstep_cols_vec_kernel", r"sinkstep_rows_vec_kernel"]}
_P, _I = ctypes.c_void_p, ctypes.c_int


def source_path(lib: str) -> Path:
    return cuda_build.CSRC / f"{lib}.cu"


def sources(libs=tuple(VARIANTS)):
    """{(library, variant): source text, or the Path of a source of its own};
    raises if a substitution misses."""
    out = {}
    for lib in libs:
        text = source_path(lib).read_text()
        for name, subs in VARIANTS[lib].items():
            if isinstance(subs, Path):
                out[(lib, name)] = subs
                continue
            s = text
            for old, new in subs:
                if old not in s:
                    raise RuntimeError(f"variant {lib}/{name}: {old!r} is not in {lib}.cu")
                s = s.replace(old, new)
            out[(lib, name)] = s
    return out


def build_all(libs):
    """{(library, variant): (CDLL, ptxas log)}; every nvcc started together."""
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (lib, name), text in sources(libs).items():
        so = out_dir / f"{lib}_{name}.so"
        if isinstance(text, Path):
            src = text
        else:
            src = so.with_suffix(".cu")
            src.write_text(text)
        procs[(lib, name)] = (cuda_build.nvcc(src, so), so)
    built = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {key[0]}/{key[1]}: nvcc exited {proc.returncode}\n{log}")
        built[key] = (ctypes.CDLL(str(so)), log)
    return built


def registers(lib: str, log: str) -> dict:
    """{kernel: [registers, spill bytes]} of the library's reported kernels."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        entry = part.split("'", 1)[0]
        for pattern in _REPORTED[lib]:
            if re.search(pattern, entry):
                spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", part)
                out[pattern] = [int(re.search(r"Used (\d+) registers", part).group(1)),
                                sum(int(x) for x in spills)]
    return out


def time_ms(fn) -> float:
    """ms per call: the median of three blocks of ITERS calls, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(3)]
    for start, end in events:
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)[1] / ITERS


def _entry(dll, name, argtypes):
    fn = getattr(dll, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _attention_inputs(B, H, N, d, count, g):
    """`count` bf16 [B, H, N, d] tensors and a ragged mask (list 0 full)."""
    tensors = [torch.randn(B, H, N, d, generator=g).to("cuda", torch.bfloat16)
               for _ in range(count)]
    lengths = torch.randint(N // 4, N + 1, (B,), generator=g)
    lengths[0] = N
    return tensors, (torch.arange(N)[None, :] < lengths[:, None]).cuda()


def bwd_cases(dll, variant):
    """[(case, launch, outputs, inputs)] of the backward's two kernels at ATTN_SHAPE,
    on the shipped forward's output and row statistics."""
    B, H, N, d = ATTN_SHAPE
    (q, k, v, dout), mask = _attention_inputs(B, H, N, d, 4, torch.Generator().manual_seed(0))
    out, row_max, row_sum = attention.FLASH_ATTN_FWD(q, k, v, mask, stats=True)
    dsum = torch.sum(dout.float() * out.float(), dim=-1)
    common = [t.data_ptr() for t in (q, k, v, dout, row_max, row_sum, dsum, mask)]
    stream = torch.cuda.current_stream().cuda_stream
    wgmma = variant == "wgmma_experiment"
    tail = [B, H, N, d, stream] if wgmma else [B, H, N, d, 1, stream]
    ints = len(tail) - 1
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    dkdv = _entry(dll, "flash_attn_bwd_dkdv" + ("_wgmma" if wgmma else ""),
                  [_P] * 10 + [_I] * ints + [_P])
    dq_fn = _entry(dll, "flash_attn_bwd_dq" + ("_wgmma" if wgmma else ""),
                   [_P] * 9 + [_I] * ints + [_P])
    keep = (q, k, v, dout, mask, out, row_max, row_sum, dsum)
    return [("dkdv", lambda: dkdv(*common, dk.data_ptr(), dv.data_ptr(), *tail), (dk, dv), keep),
            ("dq", lambda: dq_fn(*common, dq.data_ptr(), *tail), (dq,), keep)]


def fwd_cases(dll, variant):
    """[(case, launch, outputs, inputs)] of the forward with row statistics at FWD_SHAPES."""
    fn = _entry(dll, "flash_attn_fwd", [_P] * 7 + [_I] * 5 + [_P])
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for B, H, N, d in FWD_SHAPES:
        (q, k, v), mask = _attention_inputs(B, H, N, d, 3, g)
        outs = (torch.empty_like(q), torch.empty(B, H, N, device="cuda"),
                torch.empty(B, H, N, device="cuda"))
        args = [t.data_ptr() for t in (q, k, v, mask, *outs)] + [B, H, N, d, 1, stream]
        cases.append((str([B, H, N, d]), lambda args=args: fn(*args), outs, (q, k, v, mask)))
    return cases


def sink_cases(dll, variant):
    """[(case, launch, outputs, inputs)] of the half-step at SINK_SHAPE, both orientations."""
    fn = _entry(dll, "sinkstep", [_P] * 4 + [_I, _I, ctypes.c_float, _I, _P])
    B, N = SINK_SHAPE
    g = torch.Generator().manual_seed(0)
    cost = torch.randn(B, N, N, generator=g).abs().cuda()
    log_marg = torch.log_softmax(torch.randn(B, N, generator=g), dim=-1).cuda()
    log_u = torch.log_softmax(torch.randn(B, N, generator=g), dim=-1).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for name, transposed in (("cols", 0), ("rows", 1)):
        out = torch.empty_like(log_marg)
        args = [t.data_ptr() for t in (cost, log_marg, log_u, out)] + [B, N, 0.3, transposed,
                                                                       stream]
        cases.append((name, lambda args=args: fn(*args), (out,), (cost, log_marg, log_u)))
    return cases


# library -> its cases: [(case, launch, outputs, inputs)] from (CDLL, variant);
# a case keeps its inputs, which own the launch's pointers
CASES = {"flash_attn_bwd": bwd_cases, "flash_attn_fwd": fwd_cases, "sinkstep": sink_cases}


def main(argv=None) -> int:
    libs = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [lib for lib in libs if lib not in VARIANTS]
    if unknown:
        print(f"kernel_variants: unknown libraries {unknown}; known: {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    built = build_all(libs)
    cases = {key: CASES[key[0]](built[key][0], key[1]) for key in built}
    results = {key: {"ms": {}} for key in built}
    shipped = {}
    for order in (list(built), list(built)[::-1]):
        for key in order:
            lib, name = key
            diffs = {}
            for case, run, outs, _ in cases[key]:
                if run() != 0:
                    raise RuntimeError(f"{lib}/{name} {case}: CUDA error")
                torch.cuda.synchronize()
                if name == "shipped" and (lib, case) not in shipped:
                    shipped[(lib, case)] = [t.clone() for t in outs]
                diffs[case] = [float((a.float() - b.float()).abs().max())
                               for a, b in zip(outs, shipped[(lib, case)])]
                results[key]["ms"].setdefault(case, []).append(time_ms(run))
            # the pass run last decides; the outputs' max |variant - shipped|
            results[key]["same_bits_as_shipped"] = all(x == 0.0 for d in diffs.values() for x in d)
            results[key]["max_abs_diff_vs_shipped"] = diffs
    for (lib, name), rec in results.items():
        print(json.dumps({"library": lib, "variant": name,
                          "registers_spill_bytes": registers(lib, built[(lib, name)][1]), **rec,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
