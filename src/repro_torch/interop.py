"""Carry the reference's solver state into the port.

The port imports nothing of `repro`; a caller that holds both (the parity
tests) hands over numpy copies of a reference object's arrays, and these
builders make the port's counterpart on a device, so identical tiles,
edge weights and coefficients run through both packages.

  * block-ELL engines: `block_cols`, `values`, `perm`, `inv_perm` plus
    `n_orig` and `block` (a `BlockEllEngine`'s leaves);
  * COO: a `DeviceGraph`'s `src`, `dst`, `w`, `inv_deg` and `n`;
  * hub/tail: a `HubTailEngine`'s `inv_deg`, `tail_src`, `tail_dst`,
    `panel_cols`, `panel_hub`, `hub_ids` and `n_orig`;
  * sharded engines: a reference partition's stacked `src` (or
    `src_local`), `dst_local` and `weight` arrays (and for 2D the
    `col_layout_perm`), of which each rank takes its own slice;
  * a `ChebSchedule`'s coefficient vector;
  * DLRM parameters ({"table", "bot": [{"w", "b"}], "top": [...]});
  * GNN parameters (any tree of dicts and lists of arrays, the layer
    stacks `layers` / `blocks` included);
  * LM parameters (the transformer's tree, stacked on a leading [L] axis,
    MoE experts included);
  * AdamW state ({"step", "m", "v"}), so a resumed step can be held to
    the reference's from the same parameters and moments.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import flat_rank, grid_coordinate, \
    init_mesh, world_size
from repro_torch.core.engine import (BlockEllEngine, CooEngine,
                                     FusedBlockEllEngine, HubTailEngine,
                                     Sharded1DEngine, Sharded2DEngine)
from repro_torch.device import resolve_device
from repro_torch.graph.ops import DeviceGraph, as_torch_dtype

__all__ = ["block_ell_engine", "coo_engine", "hub_tail_engine",
           "sharded_1d_engine", "sharded_2d_engine",
           "device_graph_from_arrays", "coeffs_tensor", "dlrm_params",
           "gnn_params", "lm_params"]


def _tensor(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)


def block_ell_engine(block_cols, values, perm, inv_perm, n_orig: int,
                     block: int, fused: bool = True, device=None) -> BlockEllEngine:
    """A (fused) block-ELL engine over the given tiles, on `device`
    (None = cuda)."""
    dev = resolve_device(device)
    cls = FusedBlockEllEngine if fused else BlockEllEngine
    return cls(block_cols=_tensor(block_cols, torch.int32, dev),
               values=_tensor(values, torch.float32, dev),
               perm=_tensor(perm, torch.int64, dev),
               inv_perm=_tensor(inv_perm, torch.int64, dev),
               n_orig=int(n_orig), block=int(block))


def device_graph_from_arrays(src, dst, w, inv_deg, n: int,
                             device=None) -> DeviceGraph:
    """A DeviceGraph over the given edge arrays (weights keep their numpy
    dtype's float width: float32 stays float32)."""
    dev = resolve_device(device)
    w = None if w is None else np.asarray(w)
    return DeviceGraph(
        n=int(n), src=_tensor(src, torch.int32, dev),
        dst=_tensor(dst, torch.int32, dev),
        inv_deg=_tensor(inv_deg, torch.float32, dev),
        w=None if w is None else torch.from_numpy(
            np.ascontiguousarray(w)).to(dev))


def coo_engine(src, dst, w, inv_deg, n: int, device=None) -> CooEngine:
    """The COO engine over the given DeviceGraph arrays."""
    return CooEngine(device_graph_from_arrays(src, dst, w, inv_deg, n,
                                              device=device))


def hub_tail_engine(inv_deg, tail_src, tail_dst, panel_cols, panel_hub,
                    hub_ids, n: int, hub_min_deg: int = 32,
                    panel_width: int = 32, weight_dtype=None,
                    device=None) -> HubTailEngine:
    """The hub/tail engine over the given split, on `device` (None = cuda).
    `inv_deg` is read as float32 (a bf16 array widens exactly) and stored
    as `weight_dtype` (None = float32); the solve dtype is float32."""
    dev = resolve_device(device)
    wdtype = torch.float32 if weight_dtype is None \
        else as_torch_dtype(weight_dtype)
    inv = torch.from_numpy(np.array(inv_deg, np.float32)).to(wdtype)
    return HubTailEngine(
        inv_deg=inv.to(dev), tail_src=_tensor(tail_src, torch.int32, dev),
        tail_dst=_tensor(tail_dst, torch.int32, dev),
        panel_cols=_tensor(panel_cols, torch.int32, dev),
        panel_hub=_tensor(panel_hub, torch.int32, dev),
        hub_ids=_tensor(hub_ids, torch.int32, dev), n_orig=int(n),
        hub_min_deg=int(hub_min_deg), panel_width=int(panel_width))


def sharded_1d_engine(src, dst_local, weight, n_orig: int, n_pad: int,
                      rows_per_dev: int, mesh=None, comm_dtype=None,
                      device=None) -> Sharded1DEngine:
    """This rank's 1D engine over a reference `Partition1D`'s stacked
    [D, E] arrays, on `device` (None = cuda). mesh None = a 1-D mesh over
    the world (`init_mesh`), whose size must be D."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = init_mesh((world_size(),), ("dev",), device=dev)
    _, d, n_dev = flat_rank(mesh)
    if n_dev != np.shape(src)[0]:
        raise ValueError(f"partition of {np.shape(src)[0]} shards on a mesh "
                         f"of {n_dev} ranks")
    return Sharded1DEngine(
        mesh=mesh, src=_tensor(np.asarray(src)[d], torch.int32, dev),
        dst_local=_tensor(np.asarray(dst_local)[d], torch.int32, dev),
        weight=_tensor(np.asarray(weight)[d], torch.float32, dev),
        n_orig=int(n_orig), n_pad=int(n_pad),
        rows_per_dev=int(rows_per_dev), comm_dtype=comm_dtype)


def sharded_2d_engine(src_local, dst_local, weight, perm, n_orig: int,
                      n_pad: int, rows_per_chunk: int, mesh=None,
                      comm_dtype=None, device=None) -> Sharded2DEngine:
    """This rank's 2D engine over a reference `Partition2D`'s stacked
    [R, C, E] arrays and its `col_layout_perm` (None = vectors stay in
    column layout), on `device` (None = cuda). mesh None = an (R, C) mesh
    named ("row", "col") over the world."""
    dev = resolve_device(device)
    grid = tuple(np.shape(src_local)[:2])
    if mesh is None:
        mesh = init_mesh(grid, ("row", "col"), device=dev)
    if tuple(mesh.shape) != grid:
        raise ValueError(f"partition grid {grid} on a mesh "
                         f"{tuple(mesh.shape)}")
    r, c = grid_coordinate(mesh)
    perm_t = inv_t = None
    if perm is not None:
        perm = np.asarray(perm, np.int64)
        perm_t = _tensor(perm, torch.int64, dev)
        inv_t = _tensor(np.argsort(perm), torch.int64, dev)
    return Sharded2DEngine(
        mesh=mesh, src_local=_tensor(np.asarray(src_local)[r, c],
                                     torch.int32, dev),
        dst_local=_tensor(np.asarray(dst_local)[r, c], torch.int32, dev),
        weight=_tensor(np.asarray(weight)[r, c], torch.float32, dev),
        perm=perm_t, inv_perm=inv_t, n_orig=int(n_orig), n_pad=int(n_pad),
        rows_per_chunk=int(rows_per_chunk), comm_dtype=comm_dtype)


def coeffs_tensor(coeffs, device=None) -> torch.Tensor:
    """A schedule's coefficient vector as float32 on `device`."""
    return _tensor(np.asarray(coeffs), torch.float32, resolve_device(device))


def dlrm_params(params, device=None) -> dict:
    """The reference's DLRM parameters (numpy arrays in its layout: the
    table [rows, D], MLP weights [d_in, d_out] and biases) as the port's
    parameter dict of float32 tensors on `device` (None = cuda). The port
    keeps the same layout, so nothing is transposed."""
    dev = resolve_device(device)

    def mlp(layers):
        return [{k: _tensor(v, torch.float32, dev) for k, v in layer.items()}
                for layer in layers]
    return {"table": _tensor(params["table"], torch.float32, dev),
            "bot": mlp(params["bot"]), "top": mlp(params["top"])}


def gnn_params(params, device=None):
    """A reference GNN parameter tree (dicts and lists with numpy leaves,
    layer stacks on a leading axis) as the port's: the same structure with
    float32 tensors on `device` (None = cuda), each with requires_grad.
    The layouts are the same, so nothing is transposed."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _tensor(node, torch.float32, dev).requires_grad_(True)
    return conv(params)


def lm_params(params, device=None) -> dict:
    """A reference transformer parameter tree (`init_params`: dicts with
    numpy leaves stacked on a leading [L] axis, the MoE router and experts
    included) as the port's: the same tree of tensors on `device` (None =
    cuda), each in its own float width (float32 stays float32, bfloat16
    leaves become torch.bfloat16). The layouts are the same."""
    return _native_tree(params, resolve_device(device))


def _native_tree(node, dev: torch.device):
    """A tree of dicts and lists with numpy leaves as the same tree of
    tensors on `dev`, each leaf in its own dtype (bfloat16 included)."""
    if isinstance(node, dict):
        return {k: _native_tree(v, dev) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_native_tree(v, dev) for v in node]
    a = np.asarray(node)
    if a.dtype.name == "bfloat16":
        return _tensor(a.astype(np.float32), torch.float32,
                       dev).to(torch.bfloat16)
    return torch.tensor(np.ascontiguousarray(a), device=dev)


def adamw_state(state, device=None) -> dict:
    """The reference's AdamW state ({"step", "m", "v"}, numpy leaves in
    trees of dicts and lists) as the port's: "step" an int32 0-dim tensor,
    m and v the same trees of tensors on `device` (None = cuda), each in
    its own float width (bfloat16 moments stay bfloat16)."""
    dev = resolve_device(device)
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev),
            "m": _native_tree(state["m"], dev),
            "v": _native_tree(state["v"], dev)}
