"""Meshes and the card's rates (port of `repro.launch.mesh`).

The reference's production target is a pod of 256 chips: (16, 16) over
("data", "model"), or two pods, (2, 16, 16) over ("pod", "data",
"model"). The port builds those meshes over a real world of 256 or 512
ranks, and raises on any other; with `fake=True` it builds them on a
fake world of that size in this one process (`core.distributed.
init_fake_world`), as the reference's dry-run asks XLA for 512
placeholder devices: one rank's program then runs with every collective
counted and none moving a byte. `make_elastic_mesh` is the reference's
(data, model) mesh over whatever ranks there are.

The rates are the card's, NVIDIA H100 SXM 80 GB, from NVIDIA's data
sheet: bf16 tensor-core peak (dense), FP32 on the CUDA cores (the port
runs its f32 matmuls with TF32 off), HBM3 bandwidth and NVLink
bandwidth per direction. The roofline (`launch/analysis.py`) divides by
them. `mesh_kwargs` (a JAX-version shim) has no counterpart.
"""
from __future__ import annotations

from repro_torch.core import distributed as dist

__all__ = ["PEAK_FLOPS_BF16", "PEAK_FLOPS_F32", "HBM_BW", "NVLINK_BW",
           "CARD_BYTES",
           "PRODUCTION_SHAPES", "production_ranks", "make_production_mesh",
           "make_elastic_mesh"]

PEAK_FLOPS_BF16 = 989.4e12    # per card, bf16 tensor core, dense
PEAK_FLOPS_F32 = 66.9e12      # per card, FP32 CUDA cores
HBM_BW = 3.35e12              # bytes/s per card
NVLINK_BW = 450e9             # bytes/s per card, one direction
# the card's memory as torch.cuda.get_device_properties reports it on an
# NVIDIA H100 80GB HBM3 (the production dry-run's fit check, made off the
# card)
CARD_BYTES = 85_017_493_504

# multi_pod -> (mesh shape, axis names) of the reference's production mesh
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def production_ranks(multi_pod: bool) -> int:
    """Ranks of the reference's production mesh: 256, or 512 over two
    pods."""
    n = 1
    for size in PRODUCTION_SHAPES[multi_pod][0]:
        n *= size
    return n


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         fake: bool = False, rank: int = 0):
    """The (16, 16) or (2, 16, 16) mesh over a world of 256 or 512 ranks
    (`core.distributed.init_mesh`; device None = cuda). With `fake`, the
    world is first made a fake one of that many ranks, this process its
    rank `rank` (`core.distributed.init_fake_world`; any running group is
    replaced).

    Raises:
        RuntimeError: the world does not hold exactly that many ranks (the
            message names the world size).
    """
    shape, names = PRODUCTION_SHAPES[multi_pod]
    need = production_ranks(multi_pod)
    if fake:
        dist.init_fake_world(need, rank)
    dist.init_process_group(device)
    have = dist.world_size()
    if have != need:
        raise RuntimeError(
            f"the production mesh {shape} needs a world of {need} ranks; "
            f"this world has {have}")
    return dist.init_mesh(shape, names, device)


def make_elastic_mesh(n_devices: int | None = None, *,
                      model_parallel: int = 16, device=None):
    """The largest (data, model) mesh over the world's ranks (the
    reference's arithmetic: model = the largest divisor of the rank count
    not above `model_parallel`), starting the default group as
    `init_mesh` does when none is running. `n_devices`, when given, must
    be the world size: a DeviceMesh covers the whole default group.

    Raises:
        ValueError: n_devices is not the world size.
    """
    dist.init_process_group(device)
    n = dist.world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"an elastic mesh covers the world of {n} ranks, "
                         f"not {n_devices}")
    mp = min(model_parallel, n)
    while n % mp:
        mp -= 1
    return dist.init_mesh((n // mp, mp), ("data", "model"), device)
