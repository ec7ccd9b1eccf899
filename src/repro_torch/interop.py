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
  * a `ChebSchedule`'s coefficient vector;
  * DLRM parameters ({"table", "bot": [{"w", "b"}], "top": [...]}).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (BlockEllEngine, CooEngine,
                                     FusedBlockEllEngine, HubTailEngine)
from repro_torch.device import resolve_device
from repro_torch.graph.ops import DeviceGraph, as_torch_dtype

__all__ = ["block_ell_engine", "coo_engine", "hub_tail_engine",
           "device_graph_from_arrays", "coeffs_tensor", "dlrm_params"]


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
