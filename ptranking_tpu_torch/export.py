"""Exported scoring artifacts: a checkpoint's scorer lowered by `torch.export`.

    python -m ptranking_tpu_torch.export -ckpt fold1.pt -out model.pttx \
        [-batch_docs 100] [-max_docs N] [-platforms cpu,cuda] [-quantize int8]

Counterpart of ptranking_tpu/export.py. `export_scorer` lowers the scorer,
its params held in the program as constants, through `torch.export.export`
once for each padded bucket shape (B, N) and each platform, with the same
buckets, `B = max(1, round(batch_docs / N))` and doubling past the largest
bucket as the JAX package's export. Each platform has its own entry: the
`cpu` entry carries `blockwise_attention`, the `cuda` entry the registered
op `ptranking_tpu_torch::flash_attn_fwd` (ops/attention.py), whose body
launches the hand-written forward kernel; `-quantize int8` bakes the int8
weights in, and the `cuda` entry then holds `torch._int_mm`.

The artifact is the port's own format (MAGIC, then a pickled dict of
`torch.export.save` bytes); it is not the JAX package's StableHLO `.ptx`.
Serving it needs no scorer code, but it is less self-contained than
StableHLO in one way: the `cuda` entry calls the registered op, so the
process that loads it imports `ptranking_tpu_torch.ops.attention` first
(`ExportedScorer` does) and builds the attention kernels at their first
call. `python -m ptranking_tpu_torch.score` and `.serve` serve an artifact
as they serve a checkpoint.
"""

from __future__ import annotations

import argparse
import io
import pickle
from typing import Dict, Optional, Sequence, Tuple

import torch

# the registered forward op must exist before an artifact that calls it is
# traced or loaded
import ptranking_tpu_torch.ops.attention  # noqa: F401
from ptranking_tpu_torch import resolve_device
from ptranking_tpu_torch.data.dataset import DEFAULT_BUCKETS
from ptranking_tpu_torch.models.scorers import apply_scorer, tree_leaves
from ptranking_tpu_torch.train.ranker import AdhocRanker, _to_device
from ptranking_tpu_torch.types import RankingBatch

ARTIFACT_VERSION = 1
MAGIC = b"PTTX"  # the port's artifacts; the JAX package's .ptx start with JAX_MAGIC
JAX_MAGIC = b"PTRX"
PLATFORMS = ("cpu", "cuda")


def _unflatten(leaves, like):
    """A params tree of `like`'s structure with `leaves` in tree_leaves order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(like)


class _ScorerModule(torch.nn.Module):
    """The scorer as a module for torch.export: params as buffers (constants
    of the exported program), forward(features [B, N, F] fp32, mask [B, N]
    bool) -> scores [B, N] fp32."""

    def __init__(self, params, cfg):
        super().__init__()
        self.cfg = cfg
        self._structure = params
        self._names = []
        for i, t in enumerate(tree_leaves(params)):
            name = f"p{i}"
            self.register_buffer(name, t.detach().clone())
            self._names.append(name)

    def forward(self, features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        params = _unflatten([getattr(self, n) for n in self._names], self._structure)
        return apply_scorer(params, self.cfg, features, mask, training=False)


def bucket_shapes(batch_docs: int = 100, buckets: Optional[Sequence[int]] = None,
                  max_docs: Optional[int] = None) -> list:
    """The (B, N) entries of an artifact: the buckets, doubled past the largest
    until `max_docs` fits, each with the dataset's B rounding."""
    bucket_list = sorted(buckets or DEFAULT_BUCKETS)
    while max_docs is not None and bucket_list[-1] < max_docs:
        bucket_list.append(bucket_list[-1] * 2)
    return [(max(1, round(batch_docs / n)), n) for n in bucket_list]


def export_scorer(ckpt_path: str, out_path: str, batch_docs: int = 100,
                  buckets: Optional[Sequence[int]] = None,
                  platforms: Optional[Sequence[str]] = None,
                  max_docs: Optional[int] = None, quantize: str = "none",
                  device="cuda") -> Dict:
    """Export a checkpoint's scorer to a multi-shape artifact; returns the
    artifact's dict. `platforms` defaults to `device`'s type; each platform's
    programs are traced on a device of that type."""
    plats = list(platforms) if platforms else [resolve_device(device).type]
    unknown = sorted(set(plats) - set(PLATFORMS))
    if unknown:
        raise ValueError(f"unknown platforms {unknown}; choose from {PLATFORMS}")
    if quantize not in ("none", "int8"):
        raise ValueError(f"unknown quantize {quantize!r}")
    entries: Dict[Tuple[int, int], Dict[str, bytes]] = {}
    for plat in plats:
        ranker = AdhocRanker.from_checkpoint(ckpt_path, device=plat)
        if quantize == "int8":
            ranker = ranker.quantized()
        module = _ScorerModule(ranker.params, ranker.scorer_cfg).eval()
        F = ranker.scorer_cfg.num_features
        for B, n in bucket_shapes(batch_docs, buckets, max_docs):
            args = (torch.zeros(B, n, F, device=plat), torch.ones(B, n, dtype=torch.bool,
                                                                    device=plat))
            with torch.no_grad():
                program = torch.export.export(module, args)
            buf = io.BytesIO()
            torch.export.save(program, buf)
            entries.setdefault((B, n), {})[plat] = buf.getvalue()
    blob = {"version": ARTIFACT_VERSION, "num_features": F, "batch_docs": batch_docs,
            "model_id": ranker.model_id, "platforms": plats, "quantize": quantize,
            "entries": entries}
    with open(out_path, "wb") as f:
        f.write(MAGIC)
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
    return blob


def artifact_kind(path: str) -> Optional[str]:
    """'torch' for the port's artifact, 'jax' for the JAX package's .ptx,
    None for anything else (a checkpoint)."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
    return {MAGIC: "torch", JAX_MAGIC: "jax"}.get(head)


class _PlainUnpickler(pickle.Unpickler):
    """The artifact's dict holds builtins only (dicts, tuples, lists, str,
    int, bytes): no class may be loaded."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name} is not allowed in an artifact")


class ExportedScorer:
    """Serve an artifact: `predict(batch)` -> scores [B, N] (fp32, on the
    scorer's device) for a padded batch whose (B, N) the artifact has an
    entry for. Each entry is loaded at first use and kept. Duck-types the
    part of AdhocRanker that score.py and serve.py use."""

    def __init__(self, path: str, device="cuda"):
        if artifact_kind(path) != "torch":
            raise ValueError(f"{path} is not an artifact of ptranking_tpu_torch.export")
        with open(path, "rb") as f:
            f.read(len(MAGIC))
            self._blob = _PlainUnpickler(f).load()
        if self._blob["version"] > ARTIFACT_VERSION:
            raise ValueError(f"{path}: artifact version {self._blob['version']} is newer "
                             f"than this reader's {ARTIFACT_VERSION}")
        self.device = resolve_device(device)
        self.num_features = self._blob["num_features"]
        self.batch_docs = self._blob["batch_docs"]
        self.model_id = self._blob["model_id"]
        # the bucket widths the artifact has entries for: callers that bucket
        # inputs themselves (serve.py) use these
        self.buckets = tuple(sorted({n for _, n in self._blob["entries"]}))
        self._fns = {}

    def _fn(self, shape: Tuple[int, int]):
        fn = self._fns.get(shape)
        if fn is None:
            per_plat = self._blob["entries"].get(shape)
            if per_plat is None:
                raise KeyError(
                    f"no exported entry for batch shape {shape}; artifact has "
                    f"{sorted(self._blob['entries'])}. Score with -batch_docs "
                    f"{self.batch_docs}, or re-export with matching -batch_docs / a "
                    f"larger -max_docs (lists longer than the largest exported bucket "
                    f"need extra doubled buckets)")
            plat = self.device.type
            blob = per_plat.get(plat)
            if blob is None:
                raise KeyError(
                    f"artifact was exported for platforms {sorted(per_plat)} but this "
                    f"process runs on '{plat}'; re-export with -platforms {plat} "
                    f"(or cpu,cuda)")
            program = torch.export.load(io.BytesIO(blob))
            fn = self._fns[shape] = program.module()
        return fn

    @torch.inference_mode()
    def predict(self, batch: RankingBatch) -> torch.Tensor:
        f = _to_device(batch.features, self.device, torch.float32)
        m = _to_device(batch.mask, self.device, torch.bool)
        return self._fn((f.shape[0], f.shape[1]))(f, m)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ptranking_tpu_torch.export")
    p.add_argument("-ckpt", required=True, help="self-describing checkpoint (.pt or .pkl)")
    p.add_argument("-out", required=True, help="artifact path to write")
    p.add_argument("-batch_docs", type=int, default=100)
    p.add_argument("-max_docs", type=int, default=None,
                   help="longest list to serve; adds doubled buckets past 1536 like the "
                        "dataset's pick_buckets")
    p.add_argument("-platforms", default=None,
                   help="comma list of cpu,cuda (default: the -device's type)")
    p.add_argument("-quantize", default="none", choices=("none", "int8"),
                   help="int8: bake per-channel int8 weights into the artifact")
    p.add_argument("-device", default="cuda", help="torch device (cpu for tests)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    plats = args.platforms.split(",") if args.platforms else None
    blob = export_scorer(args.ckpt, args.out, batch_docs=args.batch_docs, platforms=plats,
                         max_docs=args.max_docs, quantize=args.quantize, device=args.device)
    print(f"exported {len(blob['entries'])} shapes ({blob['model_id']}, "
          f"F={blob['num_features']}, platforms={blob['platforms']}) -> {args.out}")
    return blob


if __name__ == "__main__":
    main()
