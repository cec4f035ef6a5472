"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel under ptranking_tpu_torch/ops/csrc/ with nvcc
     (all started together);
  3. kernels: each kernel against its plain torch version on the card, at the
     shapes the serving path gives it, in bf16 and fp32, with times for the
     kernel, the plain version and one PyTorch library call of the same function;
  4. serve: the flagship ranker (F=136 DASALC listsf, 6 layers, 2 heads, bf16,
     flash_attn=True) from a seeded init, saved as a .pt checkpoint, served over
     HTTP on a local port; the answers are held against the same ranker with
     dense torch attention, and the kernel's launch count must grow by 6 per
     served batch; then score_file writes a TREC run from a LETOR file.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of jax or ptranking_tpu.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

BF16_PEAK = 989e12   # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
FP32_PEAK = 67e12    # fp32 FLOP/s outside the tensor cores, H100 SXM data sheet
HBM_BYTES_S = 3.35e12

# (B, H, N, d, all_padded_rows): the long-list batch that bench.py measures
# for the JAX package (32 lists of 1408 docs), and the two ends of what the
# server's default 100-doc batches give the kernel: one list in the top
# bucket, and the smallest bucket whose remainder rows are all padding
ATTN_SHAPES = [(32, 2, 1408, 68, False), (1, 2, 1536, 68, False), (3, 2, 32, 68, True)]
# the shape whose numbers go into the kernels' JSON record: the largest that
# the serve phase gives the kernel
RECORD_SHAPE = (1, 2, 1536, 68)
# correctness only, no timing: every padded head width the kernel dispatches
# on (d rounded up to 16), N of one key and N one past a 64-key tile
EDGE_SHAPES = [(2, 3, 1, 1, False), (2, 2, 65, 8, True), (1, 3, 100, 24, False),
               (2, 1, 64, 33, True), (1, 2, 129, 64, False), (2, 2, 77, 75, True),
               (1, 1, 200, 96, False), (2, 1, 50, 112, True), (1, 2, 129, 128, False)]
# max |kernel - plain| over real query rows. fp32: both sides accumulate in
# fp32, differing only in summation order and exp rounding. bf16: the plain
# version rounds p to bf16 before p.v (as the JAX package does) and the
# kernel keeps p in fp32, and both round the output to bf16 (ulp 2^-8 near 1).
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

NUM_FEATURES = 136  # MSLR-WEB30K
# 16 queries of ragged lengths, log-spaced over 20..1408 docs
SERVE_LENGTHS = [int(round(20 * (1408 / 20) ** (i / 15))) for i in range(16)]
SERVE_REPEATS = 5
# max |served score - dense-attention score| on one doc. Both run the model in
# bf16 and differ only inside attention (the kernel keeps p in fp32, the dense
# path rounds it to bf16), which moves a score by a few bf16 ulps (2^-8 near 1)
# through the 6 layers.
SCORE_TOL = 2e-2


def phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """One line per kernel from nvcc's -Xptxas -v output: entries compiled,
    register range and spill bytes."""
    name = log.split(":", 1)[0]
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log))
    return (f"{name}: {len(regs)} entries, registers {min(regs, default=0)}.."
            f"{max(regs, default=0)}, spill stores {spills} bytes")


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_ms(fn):
    """(device busy ms, flash kernel ms, wall ms) of one call of `fn` under
    torch.profiler: the sum of the kernels' own device times, on one stream.
    The first two are None when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = flash = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        busy += us / 1e3
        if "flash_fwd_kernel" in e.key:
            flash += us / 1e3
    if busy <= 0.0:  # the profiler did not trace the card: not measured
        return None, None, wall
    return busy, flash, wall


def attention_inputs(B, H, N, d, all_padded, dtype, seed=0):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(B, H, N, d, generator=g).to("cuda", dtype) for _ in range(3))
    lengths = torch.randint(max(1, N // 4), N + 1, (B,), generator=g)
    lengths[0] = N
    if all_padded:
        lengths[-1] = 0  # a remainder row of a bucket: no real document
    mask = (torch.arange(N)[None, :] < lengths[:, None]).to("cuda")
    return q, k, v, mask


def check_close(out, ref, mask, shape, dtype) -> float:
    """Max |kernel - plain| over real query rows, under ATTN_TOL, with every
    row finite (padded ones included); raises otherwise."""
    import torch

    real = mask[:, None, :, None].expand_as(out)
    err = float((out.float() - ref.float()).abs()[real].max()) if real.any() else 0.0
    finite = bool(torch.isfinite(out.float()).all())
    name = str(dtype).split(".")[1]
    if not finite or not err <= ATTN_TOL[name]:
        raise AssertionError(f"flash_attn_fwd {name} {shape}: max_abs_err {err} "
                             f"(tol {ATTN_TOL[name]}), all finite: {finite}")
    return err


def check_attention(card: str):
    """Phase 3: the flash kernel against its plain version at every shape and
    dtype; returns the bf16 record at RECORD_SHAPE."""
    import torch
    import torch.nn.functional as Fn

    from ptranking_tpu_torch.ops.attention import FLASH_ATTN_FWD, blockwise_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for (B, H, N, d, all_padded) in EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask = attention_inputs(B, H, N, d, all_padded, dtype)
            out = FLASH_ATTN_FWD(q, k, v, mask)
            ref = blockwise_attention(q, k, v, mask, block_size=min(128, N))
            torch.cuda.synchronize()
            check_close(out, ref, mask, (B, H, N, d), dtype)
    print(f"attn edge shapes: {len(EDGE_SHAPES)} x 2 dtypes agree", flush=True)
    record = None
    for (B, H, N, d, all_padded) in ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask = attention_inputs(B, H, N, d, all_padded, dtype)
            plain = lambda: blockwise_attention(q, k, v, mask, block_size=min(128, N))
            kern = lambda: FLASH_ATTN_FWD(q, k, v, mask)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = check_close(out, ref, mask, (B, H, N, d), dtype)
            name = str(dtype).split(".")[1]
            bias = torch.where(mask, 0.0, -1e9).to(dtype)[:, None, None, :].expand(B, H, N, N)
            library = lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            iters = 20 if N >= 1024 else 200
            ms = cuda_time_ms(kern, iters)
            plain_ms = cuda_time_ms(plain, max(iters // 4, 5))
            library_ms = cuda_time_ms(library, iters)
            flops = 4.0 * B * H * N * N * d
            nbytes = 4.0 * B * H * N * d * q.element_size() + B * N
            t_ops = flops / (BF16_PEAK if dtype == torch.bfloat16 else FP32_PEAK) * 1e3
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            rec = {"shape": [B, H, N, d], "dtype": name, "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            print("attn " + json.dumps(rec) + f"  [{card}]", flush=True)
            if (B, H, N, d) == RECORD_SHAPE and dtype == torch.bfloat16:
                record = rec
    return record


def post_json(url: str, body: bytes) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        if resp.status != 200:
            raise AssertionError(f"POST {url}: HTTP {resp.status}")
        return json.loads(resp.read())


def scores_by_docid(results) -> dict:
    out = {}
    for r in results:
        for docid, s in zip(r["docids"], r["scores"]):
            if s is None or not math.isfinite(s):
                raise AssertionError(f"{r['qid']}/{docid}: non-finite score {s}")
            out[docid] = s
    return out


def serve_phase(card: str, work_dir: str) -> int:
    """Phase 4: the flagship ranker served over HTTP on the card. Returns the
    kernel's launch count from the one served request."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    from ptranking_tpu_torch import LTR_SEED
    from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries
    from ptranking_tpu_torch.data.letor import write_letor_file
    from ptranking_tpu_torch.models import ScorerConfig, apply_scorer
    from ptranking_tpu_torch.ops.attention import FLASH_ATTN_FWD
    from ptranking_tpu_torch.score import score_file
    from ptranking_tpu_torch.serve import ScoringService, make_server
    from ptranking_tpu_torch.train import AdhocRanker

    cfg = ScorerConfig.default_listsf(NUM_FEATURES, compute_dtype="bfloat16", flash_attn=True)
    ckpt = os.path.join(work_dir, "flagship.pt")
    AdhocRanker("LambdaRank", cfg, seed=LTR_SEED, device="cuda").init().save(ckpt)
    service = ScoringService(ckpt, device="cuda")  # the server's default batch_docs
    dense = ScoringService(ckpt, device="cuda")
    dense.ranker.scorer_cfg = dataclasses.replace(cfg, flash_attn=False)

    rng = np.random.RandomState(LTR_SEED)
    docs = [rng.randn(n, NUM_FEATURES).astype(np.float32) for n in SERVE_LENGTHS]
    payload = {"queries": [{"qid": f"q{i}", "docs": d.tolist()} for i, d in enumerate(docs)]}
    body = json.dumps(payload).encode()
    ds = BucketedDataset([(str(i), d, np.zeros(len(d), np.float32)) for i, d in enumerate(docs)],
                         batch_docs=service.batch_docs, num_features=NUM_FEATURES)
    n_docs = sum(SERVE_LENGTHS)

    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/score"
    try:
        FLASH_ATTN_FWD.launches = 0
        answer = post_json(url, body)
        launches = FLASH_ATTN_FWD.launches
        http_s = []
        for _ in range(SERVE_REPEATS):
            t0 = time.perf_counter()
            post_json(url, body)
            http_s.append(time.perf_counter() - t0)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if launches != 6 * len(ds):
        raise AssertionError(f"flash_attn_fwd launched {launches} times for "
                             f"{len(ds)} batches; expected 6 per batch")
    got = scores_by_docid(answer["results"])
    want = scores_by_docid(dense.score(payload)["results"])
    if len(got) != n_docs or set(got) != set(want):
        raise AssertionError(f"served {len(got)} docs, expected {n_docs}")
    score_err = max(abs(got[k] - want[k]) for k in got)
    if not score_err <= SCORE_TOL:
        raise AssertionError(f"served scores differ from dense attention by "
                             f"{score_err} (tol {SCORE_TOL})")

    service_s = []
    for _ in range(SERVE_REPEATS):
        t0 = time.perf_counter()
        service.score(payload)
        service_s.append(time.perf_counter() - t0)
    busy_ms, flash_ms, wall_ms = profile_ms(lambda: service.score(payload))
    # the scorer alone over the request's batches, already on the card, with
    # the kernel and with dense attention (CUDA events around the loop, so
    # this includes the host's enqueue time wherever the host is slower)
    batches = [(torch.from_numpy(b.features).cuda(), torch.from_numpy(b.mask).cuda())
               for b in ds.batches()]
    scorer_ms = {}
    for name, svc in (("flash", service), ("dense", dense)):
        run = lambda: [apply_scorer(svc.ranker.params, svc.ranker.scorer_cfg, x, m)
                       for x, m in batches]
        with torch.inference_mode():
            scorer_ms[name] = cuda_time_ms(run, SERVE_REPEATS, warmup=1)

    # batch scoring of a LETOR file written by the port
    queries = make_synthetic_queries(8, num_features=NUM_FEATURES, max_label=4, min_docs=20,
                                     max_docs=400, seed=LTR_SEED)
    letor = write_letor_file(queries, os.path.join(work_dir, "test.txt"), with_comment=False)
    run_path = os.path.join(work_dir, "flagship.run")
    FLASH_ATTN_FWD.launches = 0
    rows = score_file(ckpt, letor, run_path, data_id="MSLRWEB30K", device="cuda")
    file_launches = FLASH_ATTN_FWD.launches
    with open(run_path) as f:
        lines = [line.split() for line in f]
    if rows != sum(len(q[2]) for q in queries) or len(lines) != rows:
        raise AssertionError(f"score_file wrote {rows} rows for "
                             f"{sum(len(q[2]) for q in queries)} docs")
    if not all(math.isfinite(float(r[4])) for r in lines):
        raise AssertionError("score_file: non-finite scores")
    file_batches = len(BucketedDataset(queries, batch_docs=service.batch_docs))
    if file_launches != 6 * file_batches:
        raise AssertionError(f"score_file: {file_launches} kernel launches for "
                             f"{file_batches} batches; expected 6 per batch")

    med = sorted(http_s)[len(http_s) // 2]
    rec = {"lists": len(SERVE_LENGTHS), "docs": n_docs, "batches": len(ds),
           "batch_docs": service.batch_docs, "launches": launches,
           "max_abs_score_err_vs_dense": score_err,
           "http_s": http_s, "lists_per_s": len(SERVE_LENGTHS) / med, "docs_per_s": n_docs / med,
           "service_s": service_s, "profiled_service_ms": wall_ms,
           "profiled_device_busy_ms": busy_ms, "profiled_flash_kernel_ms": flash_ms,
           "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
           "scorer_loop_ms_flash": scorer_ms["flash"],
           "scorer_loop_ms_dense": scorer_ms["dense"], "score_file_rows": rows,
           "score_file_launches": file_launches}
    print("serve " + json.dumps(rec) + f"  [{card}]", flush=True)
    return launches


def main() -> int:
    phase("device")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ptranking_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(ptranking_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    card = card_line()
    print(card, flush=True)

    phase("build")
    from ptranking_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    for log in cuda_build.build(cuda_build.all_kernels()):
        print(ptxas_summary(log), flush=True)
    print(f"build_s {time.perf_counter() - t0:.1f}", flush=True)

    phase("kernels")
    flash = check_attention(card)

    phase("serve")
    work_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(work_dir, exist_ok=True)
    launches = serve_phase(card, work_dir)

    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "ptranking_tpu_torch/ops/csrc/flash_attn_fwd.cu",
        "replaces": "ptranking_tpu/ops/attention.py:129",
        "launches": launches,
        **{k: flash[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
