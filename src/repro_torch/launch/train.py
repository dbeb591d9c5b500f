"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [...]``, the counterpart of ``repro.launch.train``.

A production-shaped loop on one device: the deterministic data stream
(``data.lm.lm_batch``, the reference's bit for bit), AdamW with f32
moments and f32 gradient accumulation over ``--n-micro`` slices,
asynchronous checkpoints (``repro_torch.checkpoint``) with restart and
resume, and a per-step watchdog: a step slower than ``--watchdog`` x the
median so far is logged with its index (straggler monitoring; the
checkpoint and resume path is the recovery). Parameters come from an
explicit ``torch.Generator`` seeded by ``--seed`` (its draws are not the
reference's ``PRNGKey``'s). ``--device`` defaults to the card; ``--device
cpu`` runs on the CPU. ``--layers`` cuts each stage to that many repeats
(depth only; widths kept).

    python -m repro_torch.launch.train --arch qwen1.5-4b --layers 4
    python -m repro_torch.launch.train --arch qwen1.5-4b --smoke \\
        --device cpu --steps 20 --ckpt-dir build/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint, restore_into)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.util import resolve_device
from repro_torch.data.lm import lm_batch, to_device
from repro_torch.models import model as M
from repro_torch.models.config import Stage
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import make_train_step

__all__ = ["main", "train", "parse_args", "cut_depth"]


class Trained(NamedTuple):
    params: dict
    opt_state: dict
    losses: List[float]       # one per step run (resumed steps only)
    step_s: List[float]       # wall seconds of each step run
    start: int                # the step the run began at (resumed or 0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--watchdog", type=float, default=3.0,
                    help="flag steps slower than this multiple of median")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each stage to this many repeats")
    return ap.parse_args(argv)


def cut_depth(cfg, layers: int):
    """The config with each stage cut to at most ``layers`` repeats."""
    if layers < 1:
        raise ValueError(f"--layers must be >= 1, got {layers}")
    return dataclasses.replace(cfg, stages=tuple(
        Stage(min(s.repeat, layers), s.body) for s in cfg.stages))


def train(args: argparse.Namespace, *, log=print) -> Trained:
    """The training loop of ``main``; returns the final state, the losses
    and the step times of the steps it ran."""
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, n_micro=args.n_micro)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    opt_state = init_opt_state(params)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        if latest_step(args.ckpt_dir) is not None:
            arrays, meta = load_checkpoint(args.ckpt_dir)
            state = restore_into({"params": params, "opt": opt_state},
                                 arrays)
            params, opt_state = state["params"], state["opt"]
            start = meta["step"]
            log(f"[train] resumed from step {start}")

    durations, losses = [], []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = to_device(lm_batch(cfg, batch=args.batch, seq=args.seq,
                                   step=step, seed=args.seed), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])           # waits for the step
        dt = time.perf_counter() - t0
        durations.append(dt)
        losses.append(loss)
        med = statistics.median(durations)
        flag = (" STRAGGLER" if len(durations) > 5
                and dt > args.watchdog * med else "")
        if step % 10 == 0 or flag:
            log(f"[train] step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f}ms{flag}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state},
                      {"loss": loss})
    if ckpt:
        if losses:
            ckpt.save(args.steps, {"params": params, "opt": opt_state},
                      {"loss": losses[-1]})
        ckpt.wait()
    return Trained(params, opt_state, losses, durations, start)


def main(argv=None) -> List[float]:
    run = train(parse_args(argv))
    if run.losses:
        print(f"[train] done: first-10 mean loss "
              f"{np.mean(run.losses[:10]):.4f} -> last-10 mean loss "
              f"{np.mean(run.losses[-10:]):.4f}")
    return run.losses


if __name__ == "__main__":
    main()
