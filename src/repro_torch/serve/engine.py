"""Batched serving engine: continuous batching over a fixed slot pool.

The port of ``repro.serve.engine``.  Slot state is tracked as a
*streaming bitmap index* (one criteria column per predicate over slot
positions) and slot-selection queries (free slots, slots near the length
limit, admission picks) are query expressions executed through
``repro_torch.query`` -- on the card, through the circuit kernel (K1).
Composed selections like "occupied AND NOT near the limit" stay single
fused queries.

Slot-state maintenance goes through ``repro_torch.stream.StreamingIndex``:
all slot changes of one decode step (completions freeing slots, positions
crossing the near-limit margin) coalesce into a SINGLE batched delta
apply -- one ``_slot_version`` bump per step, never one column
reclassification per event.

Decode is the model zoo's ``decode_step`` (eager PyTorch; the reference
jits it), prefill ``forward(mode='prefill')``.  Greedy sampling.  Every
slot is decoded every step, idle ones with token 0 at their stale
position, as in the reference: a live slot never attends to another
slot's cache row, and an idle row is overwritten whole on admission.

``device=None`` means the CUDA card (``RuntimeError`` without one); the
model must lie on the engine's device.  ``devices`` (a list of torch
devices, one per shard) takes the place of the reference's ``mesh``: the
slot index is then row-sharded over them.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from pathlib import Path
from typing import Callable

import numpy as np
import torch

import repro_torch.obs as _obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitmaps import from_positions, to_positions_np
from repro_torch.device import resolve_device
from repro_torch.dist import ShardedResult
from repro_torch.models import decode_step, forward, init_cache
from repro_torch.query import And, BitmapIndex, Col, Not, Query
from repro_torch.stream import StreamingIndex

__all__ = ["Request", "ServeEngine"]

# Engine-level accounting on the process-wide registry (no-ops until
# ``repro_torch.obs.enable()``); slot-selection queries themselves report
# through the query-layer instrumentation.
_ADMISSIONS = _obs.REGISTRY.counter(
    "repro_engine_admissions_total", "Request admissions by outcome",
    ("outcome",),
)
_STEPS = _obs.REGISTRY.counter(
    "repro_engine_decode_steps_total", "Batched decode steps run",
)
_TOKENS = _obs.REGISTRY.counter(
    "repro_engine_tokens_emitted_total", "Tokens emitted across slots",
)
_OCCUPIED = _obs.REGISTRY.gauge(
    "repro_engine_occupied_slots", "Slots holding a live request",
)


def _positions(result) -> list[int]:
    """Set positions of a packed result; a sharded one is gathered first."""
    if isinstance(result, ShardedResult):
        result = result.gather()
    return to_positions_np(result).tolist()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 8,
                 max_seq: int = 256, devices=None, device=None):
        if cfg.encoder_only:
            raise ValueError("encoder-only archs have no decode step")
        self.device = resolve_device(device)
        if params.embed.device != self.device:
            raise ValueError(
                f"the model lies on {params.embed.device}, the engine runs on {self.device}"
            )
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        #: optional devices, one per shard: slot-selection queries then run
        #: through the row-sharded engine (repro_torch.dist) -- the slot
        #: universe is split across them and selections stay on the device
        #: until the positions are read out
        self.devices = None if devices is None else [torch.device(d) for d in devices]
        self.cache = init_cache(cfg, batch_slots, max_seq, torch.float32, device=self.device)
        self.requests: list[Request | None] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, np.int64)
        self._decode = partial(decode_step, cfg=cfg)
        self._prefill = partial(forward, cfg=cfg, mode="prefill", max_seq=max_seq)
        self.step_count = 0
        self._slot_version = 0  # bumped ONCE per submit / step that moved state
        self._near_margin = 8
        self._slot_stream: StreamingIndex | None = None
        self._occ_now: set = set()  # mirror of the index's occupied column
        self._near_now: set = set()  # mirror of the index's near_limit column

    # -- slot bitmap index -----------------------------------------------
    def slot_bitmap(self, predicate: Callable[[Request | None], bool]):
        """Packed bitmap of slots whose request satisfies ``predicate``."""
        idx = [i for i, r in enumerate(self.requests) if predicate(r)]
        return from_positions(idx, self.slots, device=self.device)

    def _slot_state(self, margin: int) -> tuple:
        occ, near = [], []
        for i, r in enumerate(self.requests):
            if r is None:
                continue
            occ.append(i)
            if self.pos[i] >= self.max_seq - margin:
                near.append(i)
        return occ, near

    def _build_slot_index(self, occ, near):
        # sharded: classify at word granularity so the slot universe splits
        # into as many row shards as it has words, then shard it
        idx = BitmapIndex.from_columns(
            {
                "occupied": from_positions(occ, self.slots, device=self.device),
                "near_limit": from_positions(near, self.slots, device=self.device),
            },
            r=self.slots,
            tile_words=1 if self.devices is not None else 64,
            device=self.device,
        )
        if self.devices is not None:
            idx = idx.shard(devices=self.devices)
        return idx

    def slot_index(self, near_limit_margin: int = 8):
        """Criteria columns over slot positions, ready for query expressions:
        ``occupied`` (a request holds the slot) and ``near_limit`` (its
        position is within ``near_limit_margin`` of the sequence cap).

        The default-margin index is a :class:`StreamingIndex` maintained by
        batched delta applies (one per submit / step) -- the slot columns
        are never reclassified column-wide, and when sharded each delta
        routes to the owning row shard.  A non-default margin builds a
        transient index from the current state.
        """
        if near_limit_margin != self._near_margin:
            return self._build_slot_index(*self._slot_state(near_limit_margin))
        if self._slot_stream is None:
            occ, near = self._slot_state(self._near_margin)
            self._slot_stream = StreamingIndex(self._build_slot_index(occ, near))
            self._occ_now, self._near_now = set(occ), set(near)
        return self._slot_stream.index()

    def snapshot_slot_index(self, dirpath) -> dict:
        """Checkpoint the slot-state criteria index to ``dirpath`` via
        ``repro_torch.persist``: snapshot + WAL, materialized selection views
        included.  A later engine (or replica) warm-starts from it with
        :meth:`warm_start_slot_index` instead of rebuilding."""
        self.slot_index()  # ensure the streaming index exists
        stream = self._slot_stream
        if stream.durable_dir is None:
            stream.attach_durable(dirpath)
        return stream.checkpoint()

    def warm_start_slot_index(self, dirpath) -> bool:
        """Adopt a checkpointed slot index (memmap load + WAL replay)
        instead of building one from live request state.  Returns False --
        leaving the engine to build fresh on first use -- when there is no
        usable snapshot or its slot universe doesn't match this engine."""
        if not (Path(dirpath) / "index.json").exists():
            return False
        stream = StreamingIndex.recover(dirpath, device=self.device, devices=self.devices)
        if stream.r != self.slots or not {"occupied", "near_limit"} <= set(stream.names):
            return False
        self._slot_stream = stream
        # resync the change-detection mirrors from the recovered columns
        occ, near = [], []
        for name, acc in (("occupied", occ), ("near_limit", near)):
            acc.extend(_positions(stream.execute(Col(name))))
        self._occ_now, self._near_now = set(occ), set(near)
        return True

    def _commit_slot_state(self) -> None:
        """Fold EVERY slot change since the last commit -- completions,
        admissions, positions crossing the margin -- into one batched index
        update.  One call per submit / step; bumps ``_slot_version`` once."""
        self._slot_version += 1
        if self._slot_stream is None:
            return  # index not built yet; first slot_index() reads fresh state
        occ, near = self._slot_state(self._near_margin)
        occ, near = set(occ), set(near)
        sets: dict = {}
        clears: dict = {}
        for name, want, have in (
            ("occupied", occ, self._occ_now),
            ("near_limit", near, self._near_now),
        ):
            if want - have:
                sets[name] = sorted(want - have)
            if have - want:
                clears[name] = sorted(have - want)
        if sets or clears:
            self._slot_stream.update(sets=sets, clears=clears)
        self._occ_now, self._near_now = occ, near
        _OCCUPIED.set(len(occ))

    def select_slots(self, query: Query) -> list[int]:
        """Slot ids matching a query expression over the criteria columns.
        Runs through the sharded engine when the engine holds ``devices``
        (the result is gathered only here, where positions leave the
        device)."""
        return _positions(self.slot_index().execute(query))

    def free_slots(self) -> list[int]:
        return self.select_slots(Not(Col("occupied")))

    def draining_slots(self) -> list[int]:
        """Occupied slots about to hit the length cap (eviction candidates)."""
        return self.select_slots(And(Col("occupied"), Col("near_limit")))

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> bool:
        free = self.free_slots()
        if not free:
            _ADMISSIONS.inc(1, outcome="rejected")
            return False
        _ADMISSIONS.inc(1, outcome="admitted")
        slot = free[0]
        self.requests[slot] = req
        toks = torch.tensor(req.prompt, dtype=torch.long, device=self.device)[None, :]
        # per-slot prefill: run the prompt through the model, then replace
        # this slot's WHOLE cache row (the -1 positions past the prompt too,
        # so nothing of the slot's previous request survives)
        _, caches, _ = self._prefill(self.params, batch={"tokens": toks})
        for full, new in zip(self.cache, caches):
            for f, n in zip(full, new):
                f[slot : slot + 1] = n
        self.pos[slot] = len(req.prompt)
        self._commit_slot_state()
        return True

    # -- decode ------------------------------------------------------------
    def step(self):
        """One decode step for every active slot."""
        active = [i for i, r in enumerate(self.requests) if r is not None and not r.done]
        if not active:
            return []
        last = np.zeros((self.slots, 1), np.int64)
        for i in active:
            r = self.requests[i]
            seq = r.prompt + r.out
            last[i, 0] = seq[-1]
        pos = torch.from_numpy(self.pos).to(self.device)  # per-slot positions
        logits, self.cache = self._decode(
            self.params, caches=self.cache, tokens=torch.from_numpy(last).to(self.device),
            pos=pos,
        )
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
        emitted = []
        for i in active:
            r = self.requests[i]
            r.out.append(int(nxt[i]))
            self.pos[i] += 1
            emitted.append((r.rid, int(nxt[i])))
            if len(r.out) >= r.max_new or self.pos[i] >= self.max_seq - 1:
                r.done = True
                self.requests[i] = None  # release slot
        self.step_count += 1
        _STEPS.inc(1)
        _TOKENS.inc(len(emitted))
        # every slot change this step -- completions releasing slots and
        # positions crossing the near-limit margin -- lands as ONE batched
        # delta apply on the streaming slot index
        self._commit_slot_state()
        return emitted

    def run_until_drained(self, pending: list[Request], max_steps: int = 10_000):
        done: list[Request] = []
        live: dict[int, Request] = {}
        while (pending or live) and max_steps:
            max_steps -= 1
            while pending and self.free_slots():
                req = pending.pop(0)
                if self.submit(req):
                    live[req.rid] = req
            self.step()
            for rid, r in list(live.items()):
                if r.done:
                    done.append(r)
                    del live[rid]
        return done
