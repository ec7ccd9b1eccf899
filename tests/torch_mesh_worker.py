"""One rank of the port's mesh factories over gloo, for
tests/test_torch_dryrun.py.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_mesh_worker.py OUT_DIR

Writes OUT_DIR/rank<r>.json: the shape and dimension names of
`launch.mesh.make_elastic_mesh()` over the world, and the message of
`make_production_mesh`'s refusal. Imports no jax.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from repro_torch.core import distributed as dist_mod
from repro_torch.launch import mesh as launch_mesh


def main(out_dir: str) -> int:
    torch.set_num_threads(1)
    mesh = launch_mesh.make_elastic_mesh(device="cpu")
    try:
        launch_mesh.make_production_mesh(device="cpu")
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    res = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
           "world": dist_mod.world_size(), "refusal": refusal}
    with open(Path(out_dir) / f"rank{dist_mod.rank()}.json", "w") as f:
        json.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
