"""Batched LM serving engine (port of `repro.serve.engine`): continuous
batching over a fixed-slot KV cache.

`max_batch` cache slots; incoming requests claim free slots (prefill
writes their KV prefix into the slot), every tick decodes one token for
every slot in one batched step, and finished requests free their slots.
Per-slot lengths drive the attention masks, so ragged batches decode
together.

As in the reference, a tick decodes all `max_batch` slots, the empty ones
too (token 0 at the slot's last length): an MoE layer's capacity and its
drops depend on every token of the call, so decoding only the busy slots
would change which assignments drop. The parameters are cast to the
compute dtype once, when the engine is built, and the caches are
preallocated and written in place: each tick writes one row per slot and
layer, each prefill the prompt's prefix.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.compile_log import record_compile
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (decode_attention, decode_mask,
                                       rms_norm)

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Greedy continuous-batching server over `max_batch` slots of
    `max_len` positions, on `device` (None = cuda).

    `stats` counts prefills, ticks and, for MoE configs, the assignments
    the capacity dropped (summed on the device; read it after a drain).
    `last_prefill_logits` ([1, Vp]) and `last_logits` ([max_batch, Vp])
    hold the f32 logits of the latest prefill and tick (the next tick
    overwrites the latter).

    On CUDA a tick replays one CUDA graph of the whole decode step:
    eager, the host's ~2,000 launches per tick at danube's depth take
    longer than the device's work. The graph runs the same kernels on the
    same buffers as the eager step, which the CPU always runs (and which
    setting `cuda_graph` False before the first tick selects on CUDA, to
    measure the two against each other)."""

    def __init__(self, params, cfg: tf.TransformerConfig, max_batch: int,
                 max_len: int, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tf.cast_params(params, cfg.cdtype, self.device)
        self._layers = tf.layer_views(self.params["layers"])
        self.max_batch = max_batch
        self.max_len = max_len
        self.kv = tf.make_kv_cache(cfg, max_batch, max_len,
                                   device=self.device)
        self.lengths = np.zeros(max_batch, np.int32)
        self.budget = np.zeros(max_batch, np.int32)
        self.slot_req: list[Request | None] = [None] * max_batch
        self.stats = {"prefills": 0, "ticks": 0,
                      "dropped": torch.zeros((), dtype=torch.int64,
                                             device=self.device)}
        self.last_prefill_logits = self.last_logits = None
        self.cuda_graph = self.device.type == "cuda"
        self._graph = None

    # --- device work -------------------------------------------------------
    @torch.inference_mode()
    def _prefill(self, tokens: torch.Tensor, slot: int) -> torch.Tensor:
        """Prefill one request into cache slot `slot`; its last logits."""
        k_cache, v_cache = self.kv
        s = tokens.shape[1]

        def sink(i, k, v):
            k_cache[i, slot, :s] = k[0]
            v_cache[i, slot, :s] = v[0]
        x, _ = tf._trunk(self.params, tokens, self.cfg, kv_sink=sink,
                         layers=self._layers)
        return (x[:, -1] @ self.params["lm_head"]).float()

    def _decode_core(self, tokens: torch.Tensor, lens: torch.Tensor,
                     bidx: torch.Tensor, stats: dict | None):
        """Batched one-token decode of every slot at its own length:
        tokens [B, 1], lens [B] on the device; slots `bidx` write their new
        KV row. Device work only (no host read), so a CUDA graph can
        capture it."""
        cfg, cp = self.cfg, self.params
        k_all, v_all = self.kv
        b, h, hd = self.max_batch, cfg.n_heads, cfg.head_dim
        positions = lens[:, None]
        idx = lens.long()[bidx]
        # per tick, shared by every layer: the rotation and the key mask
        rope = tf.rope_for(cfg, positions)
        valid = decode_mask(lens + 1, self.max_len, cfg.sliding_window,
                            self.device)
        x = cp["embed"][tokens]                                 # [B, 1, D]
        for i, lp in enumerate(self._layers):
            q, k, v = tf.qkv(lp, rms_norm(x, lp["ln1"]), cfg, positions, rope)
            k_all[i, bidx, idx] = k[bidx, 0]
            v_all[i, bidx, idx] = v[bidx, 0]
            att = decode_attention(q, k_all[i], v_all[i], lens + 1,
                                   window=cfg.sliding_window, valid=valid)
            x = x + att.reshape(b, 1, h * hd) @ lp["wo"]
            f, _ = tf.ffn(lp, rms_norm(x, lp["ln2"]), cfg, stats)
            x = x + f
        x = rms_norm(x, cp["final_ln"])
        return (x[:, 0] @ cp["lm_head"]).float()

    def _capture(self, tokens: np.ndarray, lengths: np.ndarray):
        """Record `_decode_core` over static input buffers in a CUDA graph.
        The warm-up runs take this tick's inputs, so the KV rows they
        write are the ones the replay writes again; they count no drops.
        The capture is logged in `repro_torch.compile_log`."""
        # every tensor the graph reads outlives it: these are attributes
        self._tok_in = torch.from_numpy(tokens).to(self.device)
        self._len_in = torch.from_numpy(lengths).to(self.device)
        record_compile(f"ServeEngine._decode_core {self.cfg.name}",
                       f"{list(self._tok_in.shape)} {self._tok_in.dtype}; "
                       f"{list(self._len_in.shape)} {self._len_in.dtype}")
        self._bidx = torch.arange(self.max_batch, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._decode_core(self._tok_in, self._len_in, self._bidx,
                                  None)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self._logits_out = self._decode_core(self._tok_in, self._len_in,
                                                 self._bidx, self.stats)

    @torch.inference_mode()
    def _decode(self, tokens: np.ndarray, lengths: np.ndarray):
        """The tick's logits [B, Vp] f32 for last tokens [B, 1] at
        `lengths`: a replay of the captured graph on CUDA (the first tick
        captures it), the eager core otherwise. A slot at max_len writes
        no KV row (the reference's scatter drops out-of-range rows), which
        the graph cannot express: such a tick runs eagerly."""
        rows = np.flatnonzero(lengths < self.max_len)
        if self.cuda_graph and len(rows) == self.max_batch:
            if self._graph is None:
                self._capture(tokens, lengths)
            self._tok_in.copy_(torch.from_numpy(tokens))
            self._len_in.copy_(torch.from_numpy(lengths))
            self._graph.replay()
            return self._logits_out
        return self._decode_core(
            torch.from_numpy(tokens).to(self.device),
            torch.tensor(lengths, device=self.device),
            torch.from_numpy(rows).to(self.device), self.stats)

    # --- engine loop -------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Prefill `req` into a free slot and take its first token; False
        when every slot is busy."""
        for slot in range(self.max_batch):
            if self.slot_req[slot] is None:
                s = len(req.prompt)
                if s + req.max_new_tokens > self.max_len:
                    raise ValueError(
                        f"request {req.rid}: prompt {s} + max_new_tokens "
                        f"{req.max_new_tokens} > max_len {self.max_len}")
                tokens = torch.as_tensor(np.asarray(req.prompt),
                                         device=self.device)[None, :]
                logits = self.last_prefill_logits = self._prefill(
                    tokens.long(), slot)
                self.slot_req[slot] = req
                self.lengths[slot] = s
                self.budget[slot] = req.max_new_tokens
                req.out_tokens.append(int(torch.argmax(logits[0])))
                self.stats["prefills"] += 1
                return True
        return False

    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def tick(self):
        """One decode step for every slot; busy slots take their token."""
        if self.active() == 0:
            return
        last = np.zeros((self.max_batch, 1), np.int64)
        for slot, req in enumerate(self.slot_req):
            if req is not None and req.out_tokens:
                last[slot, 0] = req.out_tokens[-1]
        logits = self.last_logits = self._decode(last, self.lengths)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.stats["ticks"] += 1
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.lengths[slot] += 1
            self.budget[slot] -= 1
            req.out_tokens.append(int(nxt[slot]))
            if self.budget[slot] <= 0 or \
                    self.lengths[slot] + 1 >= self.max_len:
                req.done = True
                self.slot_req[slot] = None

    def run_until_drained(self, requests: list[Request],
                          max_ticks: int = 10_000):
        pending = list(requests)
        while pending or self.active():
            while pending and self.submit(pending[0]):
                pending.pop(0)
            self.tick()
            max_ticks -= 1
            if max_ticks <= 0:
                raise RuntimeError("serve loop did not drain")
