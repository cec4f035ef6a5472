"""Time design variants of the bf16 flash-attention backward kernels on one CUDA card.

    python3 -m ptranking_tpu_torch.tools.attn_bwd_variants

Builds the shipped `ops/csrc/flash_attn_bwd.cu`, copies of it with one knob
turned or one phase cut out (text substitutions, each asserted to match), and
the warpgroup experiment `ops/csrc/experiments/flash_attn_bwd_wgmma.cu`, all
with nvcc started together. Then it times the dk/dv and the dq kernel of each
at the training shape (32, 2, 1408, 68) bf16, once in the listed order and
once in reverse, and prints one JSON line per variant: registers and spill
bytes of the head-dim-80 instantiations, the two times of each kernel in ms,
and whether dk, dv and dq equal the shipped kernels' bit for bit (a design
variant must; a variant with a phase cut out cannot, it shows what the phase
costs).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

from ptranking_tpu_torch.ops import attention, cuda_build

SHAPE = (32, 2, 1408, 68)
ITERS = 30
SOURCE = cuda_build.CSRC / "flash_attn_bwd.cu"
EXPERIMENT = cuda_build.CSRC / "experiments" / "flash_attn_bwd_wgmma.cu"

_WARPS = "constexpr int MMA_WARPS = 4;"
_BLOCKS = "return kc <= 5 ? 3 : 2;"
_SUB = "constexpr int SUB = 32;"
_MORE = "const bool more = t + 1 < tiles;"
_NO_SOFTMAX = [
    ("const float x0 = real ? s[j][2 * h] * scale : MASKED_LOGIT;", "const float x0 = s[j][2 * h];"),
    ("const float x1 = real ? s[j][2 * h + 1] * scale : MASKED_LOGIT;",
     "const float x1 = s[j][2 * h + 1];"),
    ("const float p0 = in ? __expf(x0 - m2.x) * inv2.x : 0.f;", "const float p0 = x0;"),
    ("const float p1 = in ? __expf(x1 - m2.y) * inv2.y : 0.f;", "const float p1 = x1;"),
    ("const float ds0 = real ? p0 * (dp[j][2 * h] - D2.x) : 0.f;", "const float ds0 = dp[j][2 * h];"),
    ("const float ds1 = real ? p1 * (dp[j][2 * h + 1] - D2.y) : 0.f;",
     "const float ds1 = dp[j][2 * h + 1];"),
]
_NO_SECOND_PRODUCTS = [
    ("product_kn<KC, SUB / 16>(acc_v, pa, dOt, sub, lane);",
     "acc_v[0][0] += __uint_as_float(pa[0][0] ^ pa[1][3]);"),
    ("product_kn<KC, SUB / 16>(acc_k, dsa, Qt, sub, lane);",
     "acc_k[0][0] += __uint_as_float(dsa[0][0] ^ dsa[1][3]);"),
]
# every block copies its first tile again and again: the same copy
# instructions on data that stays in the caches
_HOT_COPIES = [("q + base + size_t(q1) * d", "q + base"),
               ("dout + base + size_t(q1) * d", "dout + base"),
               ("k + base + size_t(k1) * d", "k + base"), ("v + base + size_t(k1) * d", "v + base")]
# only q (dk/dv kernel) and k (dq kernel) are copied in the loop
_HALF_COPIES = [
    ("            load_tile<LDS>(dOs + (buf ^ 1) * TILE_ELEMS, dout + base + size_t(q1) * d, nrows,\n"
     "                           TILE, d, copy_8b, ch);\n", ""),
    ("            load_tile<LDS>(Vs + (buf ^ 1) * TILE_ELEMS, v + base + size_t(k1) * d, nrows, TILE,\n"
     "                           d, copy_8b, ch);\n", "")]
# name -> substitutions in the shipped source. Design variants first: warps a
# block (rows a block owns = 16 x warps) with the blocks an SM the register
# budget is cut for, and the columns of S / dP held at a time. Then kernels
# with a phase cut out or changed: no copies of the next tile (both kernels),
# half of them, all of them from one cache-hot tile; in the dk/dv kernel no
# softmax arithmetic, no second products.
VARIANTS = {
    "shipped": [],
    "warps6_blocks2": [(_WARPS, _WARPS.replace("4", "6")), (_BLOCKS, "return kc <= 5 ? 2 : 1;")],
    "warps8_blocks1": [(_WARPS, _WARPS.replace("4", "8")), (_BLOCKS, "return 1;")],
    "warps12_blocks1": [(_WARPS, _WARPS.replace("4", "12")), (_BLOCKS, "return 1;")],
    "sub16": [(_SUB, _SUB.replace("32", "16"))],
    "sub64_blocks2": [(_SUB, _SUB.replace("32", "64")), (_BLOCKS, "return 2;")],
    "blocks2": [(_BLOCKS, "return 2;")],
    "cut_copies": [(_MORE, _MORE.replace(";", " && N < 0;"))],
    "half_copies": _HALF_COPIES,
    "hot_copies": _HOT_COPIES,
    "cut_softmax": _NO_SOFTMAX,
    "cut_second_products": _NO_SECOND_PRODUCTS,
    "cut_copies_and_softmax": [(_MORE, _MORE.replace(";", " && N < 0;")), *_NO_SOFTMAX],
}
_SIGNATURES = {"flash_attn_bwd_dkdv": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
               "flash_attn_bwd_dq": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}
_WGMMA_SIGNATURES = {
    "flash_attn_bwd_dkdv_wgmma": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "flash_attn_bwd_dq_wgmma": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]}


def build_all():
    """{name: (CDLL, ptxas log)}; every nvcc started together."""
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    sources = {}
    for name, subs in VARIANTS.items():
        s = text
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"variant {name}: {old!r} is not in {SOURCE.name}")
            s = s.replace(old, new)
        sources[name] = out_dir / f"{name}.cu"
        sources[name].write_text(s)
    sources["wgmma_experiment"] = EXPERIMENT
    procs = {name: subprocess.Popen(
        [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = (ctypes.CDLL(str(out_dir / f"{name}.so")), log)
    return libs


def registers(log: str) -> dict:
    """{kernel_kind: [registers, spill bytes]} of the head-dim-80 tensor-core entries."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        m = re.search(r"flash_bwd_(dkdv|dq)_(mma_kernelILi5E|wgmma_kernel)", part.split("'", 1)[0])
        if m:
            spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", part)
            kind = "wgmma" if "wgmma" in m.group(2) else "mma"
            out[f"{m.group(1)}_{kind}"] = [int(re.search(r"Used (\d+) registers", part).group(1)),
                               sum(int(x) for x in spills)]
    return out


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> int:
    if not torch.cuda.is_available():
        print("attn_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    libs = build_all()
    B, H, N, d = SHAPE
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v, dout = (torch.randn(B, H, N, d, generator=g).to("cuda", torch.bfloat16)
                     for _ in range(4))
    lengths = torch.randint(N // 4, N + 1, (B,), generator=g)
    lengths[0] = N
    mask = (torch.arange(N)[None, :] < lengths[:, None]).cuda()
    out, row_max, row_sum = attention.FLASH_ATTN_FWD(q, k, v, mask, stats=True)
    dsum = torch.sum(dout.float() * out.float(), dim=-1)
    stream = torch.cuda.current_stream().cuda_stream
    common = [t.data_ptr() for t in (q, k, v, dout, row_max, row_sum, dsum, mask)]

    def runners(name):
        """(dk/dv launch, dq launch, their outputs) of one library."""
        lib = libs[name][0]
        wgmma = name == "wgmma_experiment"
        for fn, argtypes in (_WGMMA_SIGNATURES if wgmma else _SIGNATURES).items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
        dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
        tail = (B, H, N, d, stream) if wgmma else (B, H, N, d, 1, stream)
        suffix = "_wgmma" if wgmma else ""

        def call(entry, *outs):
            err = getattr(lib, entry + suffix)(*common, *(t.data_ptr() for t in outs), *tail)
            if err != 0:
                raise RuntimeError(f"{name}: {entry}{suffix} returned CUDA error {err}")

        return (lambda: call("flash_attn_bwd_dkdv", dk, dv), lambda: call("flash_attn_bwd_dq", dq),
                (dk, dv, dq))

    names = list(libs)
    times = {n: {"dkdv_ms": [], "dq_ms": []} for n in names}
    shipped = None
    for order in (names, names[::-1]):
        for n in order:
            dkdv, dq, outs = runners(n)
            dkdv(), dq()
            torch.cuda.synchronize()
            if shipped is None:
                shipped = [t.clone() for t in outs]
            times[n]["same_bits_as_shipped"] = all(torch.equal(a, b) for a, b in zip(outs, shipped))
            times[n]["dkdv_ms"].append(time_ms(dkdv))
            times[n]["dq_ms"].append(time_ms(dq))
    for n in names:
        print(json.dumps({"variant": n, "shape": list(SHAPE), "dtype": "bfloat16",
                          "registers_spill_bytes": registers(libs[n][1]), **times[n],
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
