"""Batched serving: continuous batching over KV-cache slots.

The port of ``repro.serve.decode``.  The engine owns a ``n_slots``-wide
decode cache (one slot per concurrent sequence) and runs one
``decode_step`` for **all** slots in lockstep — but each slot carries its
*own* absolute position (the decode paths accept per-batch position
vectors), so sequences of different lengths coexist: this is token-level
continuous batching, not wave batching.

Life of a request:

1. ``submit()`` queues it.
2. When a slot frees, the prompt is prefilled (batch=1, full-sequence
   forward, its attention on the flash kernel where the kernel takes the
   prompt's shape) and its caches are spliced into the slot — including
   ring-buffer re-indexing for sliding-window layers and direct state
   writes for recurrent (RWKV/RG-LRU) blocks.
3. Every ``step()`` decodes one token for every active slot; finished
   sequences (EOS or token budget) retire immediately and their slot is
   refilled from the queue on the same step.

The engine runs on the card unless ``ServeConfig.device`` (or the model it
is given) says otherwise.  It records each prefill's milliseconds and
attention route (``prefills``) and each decode step's milliseconds
(``decode_ms``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from ..device import resolve
from ..models import Model, ModelConfig, build_model
from ..models.attention import ROUTES

ENC_OUT_LEN = 1500           # whisper stub frontend: fixed frame count
#: the find-DB table the engine plans prefill attention from
FLASH = "flash_attention_h100"


@dataclasses.dataclass
class ServeConfig:
    n_slots: int = 4
    max_len: int = 512
    max_new_tokens: int = 64
    temperature: float = 0.0          # 0 => greedy
    eos_token: int | None = None
    seed: int = 0
    #: find-DB directory for tuned kernel configs (None: static
    #: defaults without consulting any DB)
    servedb: str | None = None
    #: architecture key for find-DB lookups: the card's measured id
    arch: str = "h100"
    #: where a model built from a config lives (None: the card)
    device: str | None = None


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (L,) int32 token ids
    max_new_tokens: int | None = None
    frames: np.ndarray | None = None   # audio stub (enc-dec archs)


@dataclasses.dataclass
class Completion:
    uid: int
    prompt_len: int
    tokens: list[int]
    finished_reason: str               # "eos" | "length"


class ServingEngine:
    def __init__(self, model_or_cfg: Model | ModelConfig,
                 cfg: ServeConfig | None = None):
        """``model_or_cfg``: a :class:`Model` with its weights, or a config
        to build one with ``Model.init(0)`` on ``cfg.device``."""
        self.cfg = cfg or ServeConfig()
        c = self.cfg
        if isinstance(model_or_cfg, Model):
            self.model = model_or_cfg
        else:
            self.model = build_model(model_or_cfg).init(0, resolve(c.device))
        self.device = self.model.device
        self.cache = self.model.init_cache(c.n_slots, c.max_len)
        self.positions = np.zeros(c.n_slots, np.int64)
        self.active = np.zeros(c.n_slots, bool)
        self.last_token = np.zeros((c.n_slots, 1), np.int64)
        self.budget = np.zeros(c.n_slots, np.int64)
        self.slot_req: list[Request | None] = [None] * c.n_slots
        self.slot_out: list[list[int]] = [[] for _ in range(c.n_slots)]
        self.queue: deque[Request] = deque()
        self.completions: list[Completion] = []
        self.enc_out = None
        if self.model.cfg.n_enc_layers:
            self.enc_out = torch.zeros(
                (c.n_slots, ENC_OUT_LEN, self.model.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(c.seed)
        self.steps = 0
        #: one entry a prefill: uid, prompt_len, ms, route
        self.prefills: list[dict] = []
        #: milliseconds of each decode step, sampling included
        self.decode_ms: list[float] = []
        self._servedb: Any = None
        #: kernel table name -> LookupResult for this engine's dispatch
        #: shapes.  Resolved through the find-DB degradation chain, so it
        #: is populated (at worst with static defaults) under every DB
        #: state — absent, stale, or corrupt — and the engine keeps
        #: serving; the chosen tier is visible in telemetry and here.
        self.kernel_plan = self._plan_kernels()

    def _plan_kernels(self) -> dict:
        """Resolve the tuned flash-attention config at the engine's
        ``max_len`` through the find-DB.  Never raises — the never-fail
        contract of the lookup chain extends to engine construction."""
        from ..configs.common import attention_shape
        from ..servedb import ServeDB, default_config
        from ..servedb import lookup as _lookup
        c = self.cfg
        if c.servedb is not None:
            self._servedb = ServeDB(c.servedb)
            do = self._servedb.lookup
        else:
            def do(kernel, shape, arch):       # DB-less: the static floor
                return _lookup.LookupResult(
                    kernel=kernel, arch=arch, shape=shape,
                    config=default_config(kernel), tier="default",
                    detail="default:no-db")
        shape = attention_shape(self.model.cfg, c.max_len)
        return {FLASH: do(FLASH, shape, c.arch)}

    def kernel_config(self, kernel: str) -> dict:
        """The tuned (or degraded-to-default) config the engine offers the
        kernel: prefill attention takes it where it fits the prompt's
        shape, else the config the kernel's op resolves there."""
        plan = self.kernel_plan.get(kernel)
        if plan is None:
            from ..servedb import default_config
            return default_config(kernel)
        return dict(plan.config)

    # ------------------------------------------------------------------ #
    # cache splicing
    # ------------------------------------------------------------------ #
    @staticmethod
    def _splice_leaf(slot_leaf, pref_leaf, slot: int) -> None:
        """Write prefill cache (batch=1) into ``slot`` of the engine's leaf,
        in place.

        Shapes match except possibly one sequence dim (target may be longer
        — the tail is left as it was, beyond every valid position — or
        shorter — a sliding-window ring buffer)."""
        pref = pref_leaf[0].to(slot_leaf.dtype)
        diff = [i for i, (a, b) in enumerate(zip(slot_leaf.shape[1:],
                                                  pref.shape)) if a != b]
        if not diff:
            slot_leaf[slot] = pref
            return
        (d,) = diff                                 # dim in the slot row
        tgt, src = slot_leaf.shape[d + 1], pref.shape[d]
        row = slot_leaf[slot]
        if src <= tgt:                              # pad tail
            row.narrow(d, 0, src).copy_(pref)
            return
        # ring buffer: keep the last ``tgt`` rows at slots (row % tgt)
        rows = torch.arange(src - tgt, src, device=pref.device)
        idx: list[Any] = [slice(None)] * pref.dim()
        idx[d] = rows % tgt
        take: list[Any] = [slice(None)] * pref.dim()
        take[d] = rows
        row[tuple(idx)] = pref[tuple(take)]

    def _splice(self, pref_caches, slot: int) -> None:
        """Splice one request's prefill caches (one a layer) into ``slot``
        of the engine cache."""

        def walk(target, source):
            if isinstance(target, dict):
                for k in target:
                    walk(target[k], source[k])
            elif isinstance(target, tuple):
                for t, s in zip(target, source):
                    walk(t, s)
            else:
                self._splice_leaf(target, source, slot)

        for target, source in zip(self.cache, pref_caches):
            walk(target, source)

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        if len(req.prompt) + (req.max_new_tokens or
                              self.cfg.max_new_tokens) > self.cfg.max_len:
            raise ValueError(f"request {req.uid} exceeds max_len")
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.cfg.n_slots):
            if self.active[slot] or not self.queue:
                continue
            req = self.queue.popleft()
            batch = {"tokens": torch.as_tensor(
                np.asarray(req.prompt, np.int64)[None], device=self.device)}
            if req.frames is not None:
                batch["frames"] = torch.as_tensor(
                    np.asarray(req.frames)[None], device=self.device)
            before = sum(ROUTES[k] for k in ("kernel:plan",
                                             "kernel:resolved"))
            t0 = time.perf_counter()
            logits, caches, enc_out = self.model.prefill(
                batch, kernel_config=self.kernel_config(FLASH))
            first = int(self._sample(logits)[0])
            ms = (time.perf_counter() - t0) * 1e3
            kernel = sum(ROUTES[k] for k in ("kernel:plan",
                                             "kernel:resolved")) > before
            self.prefills.append({"uid": req.uid,
                                  "prompt_len": len(req.prompt), "ms": ms,
                                  "route": "kernel" if kernel else "plain"})
            self._splice(caches, slot)
            if enc_out is not None:
                self.enc_out[slot] = enc_out[0].to(self.enc_out.dtype)
            self.slot_req[slot] = req
            self.slot_out[slot] = [first]
            self.positions[slot] = len(req.prompt)      # next row to write
            self.last_token[slot, 0] = first
            self.budget[slot] = (req.max_new_tokens
                                 or self.cfg.max_new_tokens) - 1
            self.active[slot] = True
            self._maybe_finish(slot)

    def _sample(self, logits) -> np.ndarray:
        """Greedy (the first of equal maxima, as ``jnp.argmax``) or, with a
        temperature, a draw from the engine's seeded generator."""
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0] \
            .cpu().numpy()

    def _maybe_finish(self, slot: int) -> None:
        tok = self.slot_out[slot][-1]
        eos = self.cfg.eos_token is not None and tok == self.cfg.eos_token
        full = self.budget[slot] <= 0
        if eos or full:
            req = self.slot_req[slot]
            self.completions.append(Completion(
                req.uid, len(req.prompt), list(self.slot_out[slot]),
                "eos" if eos else "length"))
            self.active[slot] = False
            self.slot_req[slot] = None

    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """Admit waiting requests, decode one token for all active slots.
        Returns the number of active slots after the step."""
        self._admit()
        if not self.active.any():
            return 0
        t0 = time.perf_counter()
        logits, self.cache = self.model.decode_step(
            self.cache, torch.as_tensor(self.last_token, device=self.device),
            torch.as_tensor(self.positions, device=self.device),
            enc_out=self.enc_out)
        nxt = self._sample(logits)
        self.decode_ms.append((time.perf_counter() - t0) * 1e3)
        for slot in range(self.cfg.n_slots):
            if not self.active[slot]:
                continue
            self.slot_out[slot].append(int(nxt[slot]))
            self.last_token[slot, 0] = int(nxt[slot])
            self.positions[slot] += 1
            self.budget[slot] -= 1
            self._maybe_finish(slot)
        self.steps += 1
        return int(self.active.sum())

    def run(self, max_steps: int = 10_000) -> list[Completion]:
        """Drive until queue + slots drain; returns all completions."""
        for _ in range(max_steps):
            if not self.queue and not self.active.any():
                break
            self.step()
        return self.completions
