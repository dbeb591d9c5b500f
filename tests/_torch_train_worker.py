"""One rank of a gloo world running ``repro_torch.train.compressed_psum``
for ``tests/test_torch_train.py``; imports no JAX.

    python tests/_torch_train_worker.py RANK WORLD PORT OUT_DIR

The rank's gradients and residuals are numpy draws from seed 100 + rank
(``inputs``); it writes the mean gradients and new residuals to
OUT_DIR/rank<RANK>.npz, leaves keyed by their path."""

import os
import sys

import numpy as np

SHAPES = {"a": (7, 5), "b": (33,), "c": (4, 3, 2)}


def inputs(rank: int):
    """(grads, residuals) of ``rank``: dicts of f32 arrays, the residuals
    a tenth of the gradients' scale, one leaf of gradients all zero."""
    rng = np.random.default_rng(100 + rank)
    grads = {k: (rng.standard_normal(s) * (1 + rank)).astype(np.float32)
             for k, s in SHAPES.items()}
    grads["zero"] = np.zeros((3,), np.float32)
    res = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in grads.items()}
    res["zero"][:] = 0.0
    return grads, res


def main() -> None:
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.train import compressed_psum

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=__import__("datetime").timedelta(
                                seconds=60))
    try:
        grads, res = inputs(rank)
        mean, new = compressed_psum(
            {k: torch.as_tensor(v) for k, v in grads.items()},
            {k: torch.as_tensor(v) for k, v in res.items()})
        np.savez(os.path.join(out, f"rank{rank}.npz"),
                 **{f"mean/{k}": v.numpy() for k, v in mean.items()},
                 **{f"res/{k}": v.numpy() for k, v in new.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
