"""Rank code of ``tests/test_torch_sharding_rules.py``: one process a rank
of a 4-rank gloo world on the CPU (``python _torch_sharding_worker.py
<rank> <port> <out.json>``). It imports only ``repro_torch`` and torch.

Each rank checks that ``make_production_mesh`` refuses the 4-rank world,
then lays the world out as a (2, 2) ("data", "model") ``DeviceMesh`` and
distributes every parameter and moment leaf of a smoke config (fsdp on)
and a decode cache with ``to_placements``; it writes each leaf's
``to_local()`` shape beside ``local_shape`` of its spec, or the error."""

import json
import os
import sys
import traceback

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)


def main(rank: int, port: int, out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.sharding import local_shape, to_placements

    res = {"rank": rank}
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=4)
        try:
            make_production_mesh(device_type="cpu")
            res["refused"] = ""
        except RuntimeError as e:
            res["refused"] = str(e)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        sizes = {"data": 2, "model": 2}
        leaves = []
        for cell in ("train_4k", "decode_32k"):
            cb = build_cell("qwen1.5-4b", cell, sizes, device="meta",
                            config=get_smoke_config("qwen1.5-4b"),
                            cells={"train_4k": dict(kind="train", seq=8,
                                                    batch=4),
                                   "decode_32k": dict(kind="decode", seq=8,
                                                      batch=4)})
            for tree in cb.trees.values():
                leaves += tree.leaves()
        got = []
        for shape, dt, spec in leaves:
            full = torch.zeros(shape, dtype=dt)
            d = distribute_tensor(full, mesh, to_placements(spec, mesh))
            got.append([list(shape), [list(x) if isinstance(x, tuple)
                                      else x for x in spec],
                        list(d.to_local().shape),
                        list(local_shape(spec, shape, sizes))])
        res["leaves"] = got
        dist.destroy_process_group()
        res["ok"] = True
    except Exception:
        res["ok"] = False
        res["error"] = traceback.format_exc()
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
