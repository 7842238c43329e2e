"""One rank of the MoE mesh-path check of ``test_torch_moe_distributed.py``:
a gloo process group over a file store, a (data 4, model 2) mesh, and
``models.moe.moe_ffn`` with the mesh installed on every case of the input
file. Split cases take plain tensors (the rank's blocks); cases whose batch
the data axis does not divide take DTensors built from them. Writes the
rank's outputs, aux, dropped assignments and collective bytes by kind.

    python torch_moe_ranks.py RANK WORLD STORE_FILE INPUTS.npz OUT_DIR
"""
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import _convert
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.collectives import StepRecorder
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.sharding import context

MESH = (4, 2)


def blocks(params, di, mi, D, M):
    """The rank's blocks of the region's weights: w_gate/w_up (E, d/D,
    f/M), w_down (E, f/M, d/D), the router whole."""
    d, f = params["w_gate"].shape[1:]
    ds = slice(di * d // D, (di + 1) * d // D)
    fs = slice(mi * f // M, (mi + 1) * f // M)
    return {"router": params["router"], "w_gate": params["w_gate"][:, ds, fs],
            "w_up": params["w_up"][:, ds, fs],
            "w_down": params["w_down"][:, fs, ds]}


def main(rank, world, store, inputs, out_dir):
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    mesh = make_mesh(MESH, ("data", "model"))
    di, mi = mesh.get_coordinate()
    data = np.load(inputs)
    cases = json.loads(str(data["cases"]))
    params = _convert({k: data[k] for k in ("router", "w_gate", "w_up",
                                            "w_down")}, "cpu", torch.float32)
    local_w = blocks(params, di, mi, *MESH)
    out = {}
    for case in cases:
        cfg = ModelConfig(**case["cfg"])
        x = torch.from_numpy(data[case["x"]])
        B = x.shape[0]
        if case["dtensor"]:
            from torch.distributed.tensor import DTensor, Replicate, Shard
            place = {"router": (Replicate(), Replicate()),
                     "w_gate": (Shard(1), Shard(2)),
                     "w_up": (Shard(1), Shard(2)),
                     "w_down": (Shard(2), Shard(1))}
            p = {k: DTensor.from_local(v, mesh, place[k], run_check=False)
                 for k, v in local_w.items()}
            xin = DTensor.from_local(x, mesh, (Replicate(), Replicate()),
                                     run_check=False)
        else:
            n = B // MESH[0]
            p, xin = local_w, x[di * n:(di + 1) * n]
        context.set_profile(case["profile"])
        dropped = []
        dispatch = moe._dispatch

        def spy(experts, E, C):
            slot = dispatch(experts, E, C)
            dropped.append(int((slot == E * C).sum()))
            return slot

        moe._dispatch = spy
        try:
            with context.use_mesh(mesh, ("data",), "model"), \
                    StepRecorder() as rec:
                y, aux = moe.moe_ffn(p, xin, cfg)
        finally:
            moe._dispatch = dispatch
        if case["dtensor"]:
            y, aux = y.to_local(), aux.to_local()
        out[case["name"]] = {"y": y.tolist(), "aux": float(aux),
                             "dropped": sum(dropped),
                             "collectives": rec.collectives()}
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump({"coord": [di, mi], "cases": out}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
