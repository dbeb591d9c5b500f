"""FLOPs of the port's steps, counted by ``repro_torch.launch.op_cost``,
against the reference's ``repro.launch.hlo_cost`` of the same step
compiled by XLA on the CPU, at every arch's smoke config.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/dryrun_parity.py

Prints one line an arch: the prefill FLOPs of both (B = 2, S = 32) and
their ratio, and for qwen1.5-4b the training step's (B = 4, S = 32, two
microbatches). The reference's Mamba2 SSD runs relabelled (ROADMAP F9,
``tests/_torch_lm_reference.py``), as the port computes it.
``tests/test_torch_roofline.py`` holds the ratios of the archs without
MoE to 2% and qwen1.5-4b's training step to 10%.
"""

from __future__ import annotations

import contextlib
import os
import sys


HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, "..", "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

B, S = 2, 32


@contextlib.contextmanager
def _f9_repaired():
    from repro.models import ssm as jssm

    import _torch_lm_reference as ref
    saved = jssm.ssd_chunked
    jssm.ssd_chunked = ref.repaired
    try:
        yield
    finally:
        jssm.ssd_chunked = saved


def _jbatch(cfg, rows: int, seq: int):
    import jax.numpy as jnp
    b = {}
    if cfg.frontend == "audio":
        b["features"] = jnp.zeros((rows, seq, cfg.frontend_dim), cfg.jdtype)
        b["targets"] = jnp.zeros((rows, seq), jnp.int32)
        b["mask"] = jnp.ones((rows, seq), jnp.bool_)
        return b
    b["tokens"] = jnp.zeros((rows, seq), jnp.int32)
    if cfg.frontend == "vision":
        b["patches"] = jnp.zeros((rows, cfg.n_patches, cfg.d_model),
                                 cfg.jdtype)
        b["mrope_pos"] = jnp.zeros((rows, 3, seq), jnp.int32)
    return b


def reference_flops(arch: str, kind: str, *, rows=B, seq=S,
                    n_micro=2) -> float:
    """``hlo_cost.analyze``'s FLOPs of the reference's compiled step."""
    import jax

    from repro.configs import get_smoke_config
    from repro.launch import hlo_cost
    from repro.models import model as JM
    from repro.optim.adamw import AdamWConfig, init_opt_state
    from repro.train.step import make_train_step

    cfg = get_smoke_config(arch)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    batch = _jbatch(cfg, rows, seq)
    with _f9_repaired():
        if kind == "prefill":
            if cfg.frontend == "audio":
                batch = {"features": batch["features"]}
            fn = jax.jit(lambda p, b: JM.prefill(p, cfg, b))
            lowered = fn.lower(params, batch)
        else:
            step = make_train_step(cfg, AdamWConfig(), n_micro=n_micro)
            lowered = jax.jit(step).lower(params, init_opt_state(params),
                                          batch)
        return hlo_cost.analyze(lowered.compile().as_text()).flops


def port_flops(arch: str, kind: str, *, rows=B, seq=S, n_micro=2) -> float:
    """``op_cost``'s FLOPs of the port's step over fake CPU tensors."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.op_cost import count
    from repro_torch.launch.specs import SMOKE_CELLS, build_cell

    cell = "train_4k" if kind == "train" else "prefill_32k"
    cells = dict(SMOKE_CELLS)
    cells[cell] = dict(kind=kind, seq=seq, batch=rows)
    cb = build_cell(arch, cell, {"data": 1, "model": 1}, device="cpu",
                    n_micro=n_micro if kind == "train" else None,
                    config=get_smoke_config(arch), cells=cells)
    with cb.mode():
        _, cost = count(cb.step, *cb.inputs)
    return cost.flops


def main() -> None:
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    for arch in ARCH_IDS:
        moe = get_smoke_config(arch).moe is not None
        ref, port = reference_flops(arch, "prefill"), port_flops(arch,
                                                                "prefill")
        print(f"[parity] {arch:24s} prefill ({B} x {S}){' MoE' if moe else ''}"
              f": port {port:.6g} hlo_cost {ref:.6g} ratio "
              f"{port / ref:.6f}", flush=True)
    ref = reference_flops("qwen1.5-4b", "train", rows=4)
    port = port_flops("qwen1.5-4b", "train", rows=4)
    print(f"[parity] qwen1.5-4b train (4 x {S}, 2 microbatches): port "
          f"{port:.6g} hlo_cost {ref:.6g} ratio {port / ref:.6f}",
          flush=True)
    for arch in ARCH_IDS:
        if get_smoke_config(arch).moe is not None:
            ref = reference_flops(arch, "train", rows=4)
            port = port_flops(arch, "train", rows=4)
            print(f"[parity] {arch:24s} train (4 x {S}, 2 microbatches) "
                  f"MoE: port {port:.6g} hlo_cost {ref:.6g} ratio "
                  f"{port / ref:.6f}", flush=True)


if __name__ == "__main__":
    main()
