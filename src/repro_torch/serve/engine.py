"""Batched serving engine with per-request model-slot routing.

This is the paper's forwarding path lifted to LLM serving: one decode step
(the shared executor), a resident bank of model behaviors (adapters /
heads / full weight sets), and per-request metadata (the reg0 analogue)
selecting the slot — switching happens at request granularity with O(1)
cost and zero engine reconfiguration.

Continuous-batching-lite tick loop:

  1. ADMIT   — waiting requests fill free rows; batch formation is
               deadline-bounded (a tick never waits more than
               ``max_admit_wait_s`` for stragglers; requests past their
               deadline are rejected and counted),
  2. PREFILL — newly admitted prompts run through bucketed prefill (pow-2
               padding) and their caches are spliced into the resident
               batch cache,
  3. DECODE  — one synchronous decode step for all active rows (inactive
               rows ride along masked),
  4. RETIRE  — rows hitting max_new_tokens (or EOS) free their slot.

Adapter and head banks pass per-row slot ids into the step.  A ``full``
bank is served slot-blind, as the reference's code does (its docstring
promises per-slot segments that its code does not build).

The engine runs on its device (the card unless the caller asks for
another; the params must live there).  Host state (``tokens``,
``lengths``, ``slot_ids``, ``active``) stays in NumPy: each tick copies it
to the device once and reads the next tokens back once.

``spans`` (``repro_torch.obs.spans.SpanRecorder``, off until
``spans.start()``) times a tick from inside: ``serve.admit``,
``serve.prefill`` (one a request; ``rows`` 1, ``padded`` the bucket's pad
tokens), ``serve.splice`` (``nbytes`` of state written into the batch),
``serve.decode`` (``rows`` active; where the cache holds KV,
``kv_resident`` and ``kv_valid``: the positions it holds for those rows
and the positions valid after the step's write) and ``serve.retire``;
the ``zamba2`` family opens ``serve.decode.mamba`` and
``serve.decode.shared`` inside its step.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.obs.spans import SpanRecorder


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    slot_id: int = 0
    max_new_tokens: int = 16
    deadline_s: Optional[float] = None   # absolute deadline (time.monotonic)
    arrival_s: float = 0.0


@dataclasses.dataclass
class Finished:
    rid: int
    output: list[int]
    prompt_len: int
    latency_s: float
    rejected: bool = False


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ServeEngine:
    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        max_batch: int = 8,
        max_seq: int = 512,
        prefill_buckets: tuple[int, ...] = (32, 128, 512),
        max_admit_wait_s: float = 0.0,
        eos_token: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        held = {p.device for p in params.parameters()}
        if held != {self.device}:
            raise ValueError(f"the params live on {sorted(map(str, held))}, "
                             f"the engine runs on {self.device}")
        self.params, self.cfg = params, cfg
        self.max_batch, self.max_seq = max_batch, max_seq
        self.buckets = prefill_buckets
        self.max_admit_wait_s = max_admit_wait_s
        self.eos_token = eos_token
        self.routed = cfg.bank_mode in ("adapter", "head")

        # the cache takes its whole size at once: what unreachable objects
        # (reference cycles) still hold on the device is freed first.
        # Temporary: the benchmark's serving runner draws the weights in a
        # recursive closure (``make_weights``) that keeps its 14.7 GB of
        # Zamba2-7B drawn tensors on the card until a collection; this line
        # goes once that closure no longer holds them.
        gc.collect()
        with torch.inference_mode():
            self.cache = api.init_cache(cfg, max_batch, max_seq, device=self.device)
        self.kv_len = _kv_len(self.cache)                  # positions a KV row holds
        self.spans = SpanRecorder()
        self.tokens = np.zeros((max_batch,), np.int32)     # last token per row
        self.lengths = np.zeros((max_batch,), np.int32)    # context length
        self.slot_ids = np.zeros((max_batch,), np.int32)
        self.active = np.zeros((max_batch,), bool)
        self.row_req: list[Optional[Request]] = [None] * max_batch
        self.row_out: list[list[int]] = [[] for _ in range(max_batch)]
        self.row_start: list[float] = [0.0] * max_batch

        self.waiting: list[Request] = []
        self.finished: list[Finished] = []
        self.rejected_count = 0
        self.ticks = 0

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _decode(self) -> np.ndarray:
        """One decode step for every row: the host state goes to the device
        in one copy, the next tokens come back in one."""
        state = torch.from_numpy(
            np.stack([self.tokens, self.lengths, self.slot_ids])).to(self.device)
        tokens, lengths, slot_ids = state.long()
        inner = {"spans": self.spans} if self.spans.on else {}
        logits, self.cache = api.decode_step(
            self.params, tokens[:, None], self.cache, lengths, self.cfg,
            slot_ids if self.routed else None, **inner)
        return torch.argmax(logits[:, -1], dim=-1).cpu().numpy()

    @torch.inference_mode()
    def _prefill(self, bucket: int, prompt: list[int], slot_id: int):
        """One prompt right-padded to ``bucket``: its next token and cache."""
        n = len(prompt)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = prompt[:bucket]
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "pad_mask": (torch.arange(bucket, device=self.device) < n)
                 .to(torch.float32)[None]}
        if self.routed:
            batch["slot_ids"] = torch.tensor([slot_id], device=self.device)
        logits, _, cache = api.apply(self.params, batch, self.cfg, return_cache=True)
        return int(torch.argmax(logits[0, n - 1])), cache

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Queue ``req``.  A prompt longer than the largest prefill bucket is
        refused here, before any device work (the reference truncates it to
        the bucket and serves zeros)."""
        if len(req.prompt) > max(self.buckets):
            raise ValueError(f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                             f"is longer than the largest prefill bucket "
                             f"{max(self.buckets)}")
        req.arrival_s = time.monotonic()
        self.waiting.append(req)

    @torch.inference_mode()
    def _splice_cache(self, row: int, row_cache):
        """Write a prefill cache (leaves (..., 1, ...)) into batch row."""

        def splice(name, full, part):
            if isinstance(full, dict):
                for key in full:
                    splice(f"{name}/{key}" if name else key, full[key], part[key])
            elif name.endswith("/k") or name.endswith("/v") or name in ("k", "v"):
                # full: (L, B, G, Lmax, hd); part: (L, 1, G, S, hd)
                s = min(part.shape[3], full.shape[3])
                full[:, row, :, :s] = part[:, 0, :, :s]
            else:
                # ssm/conv state leaves: (..., B, ...) at the same position as
                # init_cache builds them — batch dim right after stack dims.
                bdim = _batch_dim(name, full.ndim)
                idx = [slice(None)] * full.ndim
                idx[bdim] = row
                pidx = [slice(None)] * part.ndim
                pidx[bdim] = 0
                full[tuple(idx)] = part[tuple(pidx)]

        splice("", self.cache, row_cache)

    def _admit(self):
        tick_start = time.monotonic()
        while self.waiting and (~self.active).any():
            req = self.waiting[0]
            now = time.monotonic()
            if req.deadline_s is not None and now > req.deadline_s:
                self.waiting.pop(0)
                self.rejected_count += 1
                self.finished.append(Finished(
                    rid=req.rid, output=[], prompt_len=len(req.prompt),
                    latency_s=now - req.arrival_s, rejected=True,
                ))
                continue
            if now - tick_start > self.max_admit_wait_s and self.ticks > 0 \
                    and self.active.any():
                break  # deadline-bounded batch formation
            self.waiting.pop(0)
            row = int(np.nonzero(~self.active)[0][0])
            self._prefill_into_row(req, row)

    def _prefill_into_row(self, req: Request, row: int):
        bucket = _bucket(len(req.prompt), self.buckets)
        sp = self.spans
        with sp.span("serve.prefill") as s:
            if sp.on:
                s.count(rows=1, padded=bucket - len(req.prompt))
            nxt, row_cache = self._prefill(bucket, req.prompt, req.slot_id)
        # NOTE: bucket padding attends over pad tokens to the right of the
        # prompt; the splice copies the first min(bucket, cache length)
        # positions, as the reference's does.  Decode reads a row's KV only
        # below its length, which its own writes fill past the prompt.
        with sp.span("serve.splice") as s:
            if sp.on:
                s.count(nbytes=_nbytes(row_cache))
            self._splice_cache(row, row_cache)
        self.active[row] = True
        self.lengths[row] = len(req.prompt)
        self.tokens[row] = nxt
        self.slot_ids[row] = req.slot_id
        self.row_req[row] = req
        self.row_out[row] = [nxt]
        self.row_start[row] = time.monotonic()

    def _retire(self):
        for row in range(self.max_batch):
            if not self.active[row]:
                continue
            req = self.row_req[row]
            out = self.row_out[row]
            done = len(out) >= req.max_new_tokens or (
                self.eos_token is not None and out and out[-1] == self.eos_token
            )
            if done:
                self.finished.append(Finished(
                    rid=req.rid, output=list(out), prompt_len=len(req.prompt),
                    latency_s=time.monotonic() - req.arrival_s,
                ))
                self.active[row] = False
                self.row_req[row] = None

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine tick; returns number of active rows decoded."""
        sp = self.spans
        with sp.span("serve.admit"):
            self._admit()
        if not self.active.any():
            self.ticks += 1
            return 0
        with sp.span("serve.decode") as s:
            if sp.on:
                rows = int(self.active.sum())
                valid = np.minimum(self.lengths[self.active] + 1, self.kv_len)
                s.count(rows=rows, kv_resident=rows * self.kv_len or None,
                        kv_valid=int(valid.sum()) if self.kv_len else None)
            nxt = self._decode()
        with sp.span("serve.retire"):
            for row in range(self.max_batch):
                if self.active[row]:
                    self.lengths[row] += 1
                    self.tokens[row] = nxt[row]
                    self.row_out[row].append(int(nxt[row]))
            self._retire()
        self.ticks += 1
        return int(self.active.sum())

    def run_until_done(self, max_ticks: int = 10_000) -> list[Finished]:
        while (self.waiting or self.active.any()) and self.ticks < max_ticks:
            self.step()
        return self.finished


def _leaves(tree):
    if isinstance(tree, dict):
        for key, v in tree.items():
            yield from ((f"{key}/{n}" if n else key, t) for n, t in _leaves(v))
    else:
        yield "", tree


def _kv_len(cache) -> int:
    """Positions a row of the cache's KV holds (0: the cache holds none)."""
    for name, t in _leaves(cache):
        if name.split("/")[-1] == "k":
            return int(t.shape[-2])
    return 0


def _nbytes(cache) -> int:
    """Bytes of a cache tree's leaves."""
    return sum(t.numel() * t.element_size() for _, t in _leaves(cache))


def _batch_dim(name: str, ndim: int) -> int:
    if name.endswith("ssm"):
        return ndim - 4
    if name.endswith("conv"):
        return ndim - 3
    return 1
