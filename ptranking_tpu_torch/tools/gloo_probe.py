"""Which gloo collectives take CUDA tensors as they are, on this machine.

The context-parallel collectives (parallel/ring.py) send and receive around
the `seq` ring and call all_to_all; under gloo they stage CUDA tensors
through host memory, a route chosen by the group's backend. This probe
says whether that staging is needed: for each op it spawns two gloo ranks
that hand it CUDA tensors directly, each pair in its own processes (a rank
that faults does not hide the others), and prints one JSON object
{op: "ok" | the failure}. Run on a machine with a card:

    python3 -m ptranking_tpu_torch.tools.gloo_probe
"""

from __future__ import annotations

import json
import sys

OPS = ("batch_isend_irecv", "all_to_all_single", "all_gather", "all_reduce_max")


def _op(name: str) -> str:
    """One rank's try of `name` on CUDA tensors; the values are checked."""
    import torch
    import torch.distributed as dist

    rank, dev = dist.get_rank(), torch.device("cuda", 0)
    t = torch.full((4,), float(rank + 1), device=dev)
    if name == "batch_isend_irecv":
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, 1 - rank), dist.P2POp(dist.irecv, out, 1 - rank)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        want = [float(2 - rank)] * 4
    elif name == "all_to_all_single":
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        want = [1.0, 1.0, 2.0, 2.0]
    elif name == "all_gather":
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        out, want = torch.cat(parts), [1.0] * 4 + [2.0] * 4
    else:
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        want = [2.0] * 4
    got = out.cpu().tolist()
    return "ok" if got == want else f"wrong values {got}"


def main() -> int:
    import torch

    from ptranking_tpu_torch.parallel.launch import run_ranks

    if not torch.cuda.is_available():
        print("gloo_probe: needs a CUDA card", file=sys.stderr)
        return 1
    result = {}
    for name in OPS:
        try:
            res = run_ranks(_op, 2, (name,), device_type="cuda", backend="gloo",
                            timeout_s=60, join_timeout_s=120)
            result[name] = res[0] if res[0] == res[1] else str(res)
        except (RuntimeError, TimeoutError) as exc:
            result[name] = str(exc).strip().splitlines()[-1][:300]
    print(json.dumps({"torch": torch.__version__, "gloo_cuda": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
