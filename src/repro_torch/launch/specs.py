"""Per-(arch x shape-cell) steps, inputs and layouts of the dry run: the
counterpart of ``repro.launch.specs``.

Every cell resolves to a step of the port + inputs that allocate nothing
(``FakeTensor``s on the card's device type by default, on the CPU for the
tests, or ``meta`` tensors) + the spec of every leaf of every tree
(``models.sharding.logical_to_spec`` under the mesh's rules):

  train_4k    -> train_step(params, opt_state, batch)     seq 4096,  gb 256
  prefill_32k -> prefill(params, batch)                   seq 32768, gb 32
  decode_32k  -> decode_step(params, cache, tok, pos)     cache 32k, gb 128
  long_500k   -> decode_step with a 524288-token cache,   gb 1

Skip policy (DESIGN.md §4): encoder-only archs have no decode cells;
long_500k requires sub-quadratic layers. ``khi-serve`` has its own cell
(serve_b256): the sharded fan-out search's index and query layout and
its ``SearchParams``; its hop loop syncs with the host every hop, so the
dry run counts its work from the fused gather's shapes instead of
running it.

Fake parameters come from ``model.param_specs`` (``torch.empty`` in the
fake mode), never from a random draw.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..core.util import resolve_device
from ..models import model as M
from ..models.config import ModelConfig, Stage
from ..models.sharding import axis_rules, logical_to_spec
from ..optim import AdamWConfig, init_opt_state
from ..train import make_train_step
from .mesh import sharding_rules

__all__ = ["CELLS", "SMOKE_CELLS", "CellBuild", "Tree", "batch_logical",
           "build_cell", "cache_logical", "cell_supported", "cut_stages",
           "pick_n_micro", "rules_for", "zero_specs"]

CELLS: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# the same cells at the smoke configs' scale (tests on the CPU)
SMOKE_CELLS: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq=32, batch=64),
    "prefill_32k": dict(kind="prefill", seq=64, batch=32),
    "decode_32k": dict(kind="decode", seq=64, batch=32),
    "long_500k": dict(kind="decode", seq=128, batch=1),
}


def cell_supported(cfg, cell: str) -> Tuple[bool, str]:
    if getattr(cfg, "name", "").startswith("khi-serve"):
        return cell == "serve_b256", "khi-serve has its own serve cell"
    kind = CELLS[cell]["kind"]
    if cfg.encoder_only and kind == "decode":
        return False, "encoder-only arch: no decode step"
    if cell == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped"
    return True, ""


def pick_n_micro(cfg: ModelConfig, batch: int, seq: int, sizes: dict) -> int:
    """Choose grad-accum microbatches so the per-device logits slice stays
    under ~1 GB (bf16 logits + f32 softmax ~ 6 B/elt). FSDP-class archs
    (>8B params, full remat) go straight to per-device microbatch 1: their
    activation footprint, not throughput, binds first."""
    data = sizes.get("data", 1) * sizes.get("pod", 1)
    b_local = max(batch // data, 1)
    if cfg.n_params() > 8e9:
        return b_local
    vshard = sizes.get("model", 1) if cfg.vocab % sizes.get("model", 1) == 0 else 1
    budget = 1.0e9
    n = 1
    while (b_local / n) * seq * (cfg.vocab / vshard) * 6 > budget and n < b_local:
        n *= 2
    return n


def rules_for(sizes: dict, variant: str = "") -> dict:
    """``sharding_rules`` of a mesh with the axes of ``sizes`` (in its
    order); ``fsdppod`` fully shards parameters over pod and data."""
    rules = sharding_rules(types.SimpleNamespace(
        mesh_dim_names=tuple(sizes)))
    if variant == "fsdppod" and "pod" in sizes:
        rules = {**rules, "fsdp": ("pod", "data")}
    return rules


# ----------------------------------------------------------------- trees

def _map(fn, tree, *rest):
    """fn over the leaves of nested dicts and lists (tuples are leaves:
    specs and shapes), with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@dataclasses.dataclass
class Tree:
    """One argument or output of a step: its leaves' (shape, dtype) and
    specs (the same nesting), and whether the reference donates it."""
    shapes: Any
    specs: Any
    donated: bool = False

    def leaves(self):
        """(shape, dtype, spec) of every leaf."""
        return [(s[0], s[1], p) for s, p in zip(_leaves(self.shapes),
                                                 _leaves(self.specs))]


def _tree(shapes, logical, donated=False) -> Tree:
    return Tree(shapes, _map(lambda s, ax: logical_to_spec(ax, s[0]), shapes,
                             logical), donated)


def _batch_shapes(cfg: ModelConfig, B: int, S: int, *, with_targets: bool):
    i32 = torch.int32
    b: Dict[str, Any] = {}
    if cfg.frontend == "audio":
        b["features"] = ((B, S, cfg.frontend_dim), cfg.torch_dtype)
        if with_targets:
            b["targets"] = ((B, S), i32)
            b["mask"] = ((B, S), torch.bool)
        return b
    b["tokens"] = ((B, S), i32)
    if cfg.frontend == "vision":
        b["patches"] = ((B, cfg.n_patches, cfg.d_model), cfg.torch_dtype)
        b["mrope_pos"] = ((B, 3, S), i32)
    return b


_BATCH_AXES = {"tokens": ("batch", None), "features": ("batch", None, None),
               "targets": ("batch", None), "mask": ("batch", None),
               "patches": ("batch", None, None),
               "mrope_pos": ("batch", None, None)}


def batch_logical(batch_shapes) -> dict:
    return {k: _BATCH_AXES[k] for k in batch_shapes}


def cache_logical(cfg: ModelConfig):
    def for_spec(spec):
        if spec.mixer == "ssm":
            return {"conv": (None, "batch", None, "ffn"),
                    "ssm": (None, "batch", "heads", None, None)}
        if cfg.mla is not None:
            return {"c": (None, "batch", "seq_kv", None),
                    "kr": (None, "batch", "seq_kv", None)}
        return {"k": (None, "batch", "seq_kv", "kv_heads", None),
                "v": (None, "batch", "seq_kv", "kv_heads", None)}
    return [
        {f"l{j}": for_spec(spec) for j, spec in enumerate(stage.body)}
        for stage in cfg.stages]


def _param_shapes(cfg: ModelConfig):
    return M._map(M.param_specs(cfg), lambda leaf, _: (leaf[1], leaf[2]))


def _cache_shapes(cfg: ModelConfig, B: int, T: int):
    with torch.device("meta"):
        cache = M.init_cache(cfg, B, T, device="meta")
    return _map(lambda t: (tuple(t.shape), t.dtype), cache)


def zero_specs(param_specs, shapes, sizes: dict):
    """ZeRO-1 moment specs: the param's spec plus `data` on the first
    free dim whose size divides the data axis (shape-aware: the logical
    zeroify can land on a non-divisible scan dim and silently
    replicate). ``shapes`` is the parameter tree's shapes (a leaf a
    shape tuple, or a (shape, dtype) pair)."""
    data = sizes.get("data", 1)

    def one(spec, shape):
        if shape and isinstance(shape[0], tuple):
            shape = shape[0]
        spec = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for e in spec
                for a in (e if isinstance(e, tuple) else (e,)) if a}
        if "data" not in used and data > 1:
            for i, (e, dim) in enumerate(zip(spec, shape)):
                if e is None and dim % data == 0:
                    spec[i] = "data"
                    break
        return tuple(spec)

    return _map(one, param_specs, shapes)


def cut_stages(cfg: ModelConfig, repeats) -> ModelConfig:
    """The config with stage i run ``repeats[i]`` times (depth only)."""
    return dataclasses.replace(cfg, stages=tuple(
        Stage(int(r), s.body) for s, r in zip(cfg.stages, repeats)))


def _variant_cfg(cfg: ModelConfig, variant: str) -> ModelConfig:
    if variant.startswith("ep") and cfg.moe is not None:
        # "ep48" or "ep48cap10" (pad experts; optionally capacity 1.0)
        pad = int(variant[2:].split("cap")[0])
        cap = 1.0 if "cap10" in variant else cfg.moe.capacity_factor
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, pad_to=pad,
                                         capacity_factor=cap))
    return cfg


# ----------------------------------------------------------------- cells

@dataclasses.dataclass
class CellBuild:
    """A cell of the dry run: ``step(*inputs)`` runs it over the fake
    ``inputs`` (enter ``mode()`` around the call, so the tensors the step
    makes are fake too); ``trees`` and ``out_trees`` name each argument
    and output tree's leaves, specs and donation; ``meta`` is the
    reference's. ``instantiate(cfg, rows, n_micro)`` gives the (step,
    inputs) of the same cell at another depth or batch."""
    arch: str
    cell: str
    kind: str
    cfg: Any
    sizes: dict
    rules: dict
    meta: dict
    device: torch.device
    fake_mode: Any
    step: Optional[Callable]
    inputs: tuple
    trees: Dict[str, Tree]
    out_trees: Dict[str, Tree]
    n_micro: int = 1
    search_params: Any = None

    def mode(self):
        return self.fake_mode if self.fake_mode is not None else \
            contextlib.nullcontext()

    def instantiate(self, cfg: ModelConfig, rows: int, n_micro: int = 1):
        with self.mode():
            return _instantiate(cfg, self.kind, rows, self.meta["seq"],
                                self.device, n_micro)


def _empty(shape_dtype, device):
    shape, dt = shape_dtype
    return torch.empty(shape, dtype=dt, device=device)


def _instantiate(cfg: ModelConfig, kind: str, rows: int, seq: int, device,
                 n_micro: int = 1):
    """(step, inputs) of a cell's kind at ``rows`` batch rows; call it in
    the cell's fake mode."""
    params = _map(lambda s: _empty(s, device), _param_shapes(cfg))
    if kind == "train":
        batch = _map(lambda s: _empty(s, device),
                     _batch_shapes(cfg, rows, seq, with_targets=True))
        step = make_train_step(cfg, AdamWConfig(), n_micro=n_micro)
        return step, (params, init_opt_state(params), batch)
    if kind == "prefill":
        batch = _map(lambda s: _empty(s, device),
                     _batch_shapes(cfg, rows, seq, with_targets=False))
        return (lambda p, b: M.prefill(p, cfg, b)), (params, batch)
    cache = M.init_cache(cfg, rows, seq, device=device)
    tok = torch.empty((rows, 1), dtype=torch.int32, device=device)
    pos = seq - 1

    def dec(p, c, t):
        return M.decode_step(p, cfg, c, t, pos)
    return dec, (params, cache, tok)


def _fake_mode(device: torch.device):
    if device.type == "meta":
        return None
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def build_cell(arch: str, cell: str, sizes: dict, *,
               n_micro: Optional[int] = None, variant: str = "",
               device="cuda", config: Optional[ModelConfig] = None,
               cells: Optional[Dict[str, dict]] = None) -> CellBuild:
    """The cell's step, fake inputs, trees and meta over a mesh of axis
    ``sizes`` (``{"data": 16, "model": 16}``, ...). ``variant`` selects
    the reference's layout transforms: ``ep<N>`` (pad the MoE expert axis
    to N, ``cap10`` capacity 1.0), ``nofsdp``, ``fsdppod``, and for
    khi-serve ``bf16vec`` and ``hops64``. ``config`` and ``cells``
    replace the arch's config and the cell table (the tests' smoke
    scale); ``device`` is where the fake tensors lie: "cuda" (default),
    "cpu" or "meta"."""
    dev = torch.device("meta") if str(device) == "meta" else \
        resolve_device(device)
    rules = rules_for(sizes, variant)
    if arch == "khi-serve":
        return _build_khi(cell, sizes, rules, dev, variant)
    cfg = _variant_cfg(config or get_config(arch), variant)
    ok, why = cell_supported(cfg, cell)
    if not ok:
        raise ValueError(f"{arch} x {cell} unsupported: {why}")
    info = (cells or CELLS)[cell]
    kind, B, S = info["kind"], info["batch"], info["seq"]
    use_fsdp = kind == "train" and variant != "nofsdp"
    pshapes = _param_shapes(cfg)
    with axis_rules(rules, sizes):
        params = _tree(pshapes, M.param_logical_axes(cfg, fsdp=use_fsdp),
                       donated=kind == "train")
    meta = dict(arch=arch, cell=cell, kind=kind, batch=B, seq=S,
                n_params=int(sum(np.prod(s[0]) for s in _leaves(pshapes))),
                n_active=cfg.n_active_params())
    scalar = Tree(((), torch.float32), ())
    nm = 1
    with axis_rules(rules, sizes):
        if kind == "train":
            nm = n_micro or pick_n_micro(cfg, B, S, sizes)
            meta["n_micro"] = nm
            bshapes = _batch_shapes(cfg, B, S, with_targets=True)
            mom = zero_specs(params.specs, pshapes, sizes)
            f32 = _map(lambda s: (s[0], torch.float32), pshapes)
            opt = Tree({"mu": f32, "nu": f32, "step": ((), torch.int32)},
                       {"mu": mom, "nu": mom, "step": ()}, donated=True)
            trees = {"params": params, "opt_state": opt,
                     "batch": _tree(bshapes, batch_logical(bshapes))}
            outs = {"params": params, "opt_state": opt,
                    "metrics": Tree({k: scalar.shapes for k in
                                     ("loss", "aux", "lr", "grad_norm")},
                                    {k: () for k in
                                     ("loss", "aux", "lr", "grad_norm")})}
        elif kind == "prefill":
            bshapes = _batch_shapes(cfg, B, S, with_targets=False)
            trees = {"params": params,
                     "batch": _tree(bshapes, batch_logical(bshapes))}
            outs = {"logits": _tree(((B, 1, cfg.vocab), cfg.torch_dtype),
                                    ("batch", None, None)),
                    "cache": _tree(_cache_shapes(cfg, B, S),
                                   cache_logical(cfg))}
        else:
            cache = _tree(_cache_shapes(cfg, B, S), cache_logical(cfg),
                          donated=True)
            trees = {"params": params, "cache": cache,
                     "tokens": Tree(((B, 1), torch.int32), ()),
                     "pos": Tree(((), torch.int32), ())}
            outs = {"logits": _tree(((B, 1, cfg.vocab), cfg.torch_dtype),
                                    ("batch", None, None)),
                    "cache": cache}
    cb = CellBuild(arch=arch, cell=cell, kind=kind, cfg=cfg, sizes=sizes,
                   rules=rules, meta=meta, device=dev,
                   fake_mode=_fake_mode(dev), step=None, inputs=(),
                   trees=trees, out_trees=outs, n_micro=nm)
    cb.step, cb.inputs = cb.instantiate(cfg, B, nm)
    return cb


def _build_khi(cell: str, sizes: dict, rules: dict, dev, variant: str
               ) -> CellBuild:
    """khi-serve: the sharded fan-out search's layout (one shard of the
    index a ``model`` rank, the query batch split over the data axes)."""
    from ..configs.khi_serve import config as khi_config
    from ..core.engine import SearchParams
    from ..core.sharded import sharded_input_specs

    kc = khi_config()
    ok, why = cell_supported(kc, cell)
    if not ok:
        raise ValueError(f"khi-serve x {cell} unsupported: {why}")
    batch = 256 * sizes.get("pod", 1)
    n_shards = sizes["model"]
    skhi, q = sharded_input_specs(
        n_per_shard=kc.n_per_shard, d=kc.d, m=kc.m, height=kc.height,
        nodes_per_shard=kc.nodes_per_shard, M=kc.M, n_shards=n_shards,
        batch=batch,
        vec_dtype=torch.bfloat16 if variant == "bf16vec" else None)
    hops = 64 if variant == "hops64" else kc.ef
    # strategy stays "graph", as the reference's lowering: the graph
    # program is the cell's worst-case device cost (DESIGN.md §10); the
    # port's graph lanes score with the fused gather kernel
    params = SearchParams(k=kc.k, ef=kc.ef, c_e=kc.c_e, c_n=kc.c_n,
                          max_hops=hops, expand_width=kc.expand_width,
                          router=kc.router, frontier_cap=kc.frontier_cap,
                          backend=kc.backend)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    index = {f.name: getattr(skhi.di, f.name)
             for f in dataclasses.fields(skhi.di)
             if torch.is_tensor(getattr(skhi.di, f.name))}
    index["offsets"] = skhi.offsets

    def shape_of(t):
        return (tuple(t.shape), t.dtype)

    ishapes = {k: shape_of(t) for k, t in index.items()}
    ispecs = {k: ("model",) + (None,) * (len(s[0]) - 1)
              for k, s in ishapes.items()}
    qshapes = {k: shape_of(t) for k, t in q.items()}
    qspecs = {k: (data_axes, None) for k in qshapes}
    meta = dict(arch="khi-serve", cell=cell, kind="serve", batch=batch,
                seq=kc.n_per_shard, n_params=0, n_active=0, d=kc.d, m=kc.m,
                M=kc.M, ef=kc.ef, max_hops=hops, height=kc.height,
                k=kc.k, c_n=kc.c_n, expand_width=kc.expand_width)
    trees = {"index": Tree(ishapes, ispecs), "queries": Tree(qshapes, qspecs)}
    outs = {"ids": Tree(((batch, kc.k), torch.int32), (data_axes, None)),
            "dists": Tree(((batch, kc.k), torch.float32), (data_axes, None))}
    return CellBuild(arch="khi-serve", cell=cell, kind="serve", cfg=kc,
                     sizes=sizes, rules=rules, meta=meta, device=dev,
                     fake_mode=None, step=None, inputs=(), trees=trees,
                     out_trees=outs, search_params=params)
