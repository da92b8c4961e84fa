"""Continuous-batching serving engine: a slotted request pool (port of
``repro.launch.batcher``).

The static serving loop (``ServeSetup.make_generate``) advances one batch in
lockstep until its last row finishes, so under skewed lengths short
requests pin their slot while a straggler drains.  This engine keeps a pool
of ``slots`` rows, each with its own absolute position, its own remaining
budget and an active mask:

* **admit** - queued requests are prefilled slot-locally at their exact
  prompt length and their decode state (LLN ``(s, z)`` plus the diag tail,
  a softmax KV block, SSM states) is written into the freed pool rows
  (``PoolSetup.admit_fn``) while the other rows keep theirs.  Same-length
  queued prompts admit as one batched prefill (exact: the pool calibrates
  per row);
* **decode** - ``segment`` steps per ``PoolSetup.segment_fn`` call;
* **evict** - a row whose budget reaches zero drops out of the active mask
  inside the segment (masked rows advance nothing, by the decode
  contract), and its slot goes back to the queue at the next boundary.

The engine is driven by the host between segments.  Robustness layer:

* **lifecycle guards** - admission validates every request and rejects it
  with a typed :class:`AdmissionError` / :class:`QueueFullError`;
  per-request ``deadline_s`` budgets are enforced at segment boundaries;
  every request ends with a status (``done | timeout | rejected | failed |
  retried``) in :class:`BatchingStats`;
* **state-health sentinel** - ``segment_fn`` returns a per-row
  ``unhealthy`` flag (``core/health.py``).  A flagged row is quarantined:
  its segment tokens are discarded, its slot is evicted and the request is
  re-queued with exponential backoff.  On re-admission its row is rebuilt
  bit for bit: its admission group re-prefilled (the same batch, so the
  same kernels and sums), then each of its recorded steps rerun through
  ``PoolSetup.replay_fn`` (the partial commit, on the step's own inputs:
  a speculative row's verify chunks hold its rejected drafts too);
* **streaming concentration telemetry** - the last segment's summary over
  live rows lands in ``BatchingStats.telemetry``; with
  ``HealthConfig.check_drift`` a drifting row is quarantined as above;
* **snapshot/restore** - with a ``snapshot_mgr``
  (``checkpoint/manager.py:CheckpointManager``) the serving carry (pool
  caches, tok/pos/remaining/active, the sampling generator's state) and
  the host metadata (queue, per-row request map, outputs, statuses, as a
  JSON sidecar) are saved atomically every ``snapshot_every`` segments;
  ``run(resume=True)`` resumes every in-flight request after a crash;
* **fault injection** - ``run(fault_plan=...)`` applies a
  ``launch/faults.py:FaultPlan`` (NaN poison, drop, delay, kill) at
  segment boundaries;
* **straggler watchdog** - each segment's wall clock feeds a
  ``distributed/straggler.py:StepWatchdog``; anomalies surface in the
  stats.

Speculative pools (``PoolSetup.spec_k >= 1``) emit up to ``spec_k + 1``
tokens per row and step: the harvest reads an (S, B, E) token panel with
int counts (E = 1 for plain pools), caps each row at its budget, and the
stats carry the acceptance counters, per run and per request.

On a mesh (``PoolSetup.mesh``) every rank runs this engine on the same
requests: the segment's outputs come whole to every rank (:func:`_host`),
and a deadline counts as passed where any rank's clock says so
(:meth:`ContinuousBatcher._agreed`), so every rank admits, evicts and
quarantines the same rows and keeps the same queue.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import restore as _restore_tree
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.distributed.straggler import StepWatchdog
from repro_torch.launch.faults import FaultPlan, SimulatedCrash, poison_rows
from repro_torch.launch.steps import PoolSetup, make_pool_setup
from repro_torch.tree import map_with_path


def _host(t) -> np.ndarray:
    """A segment output on the host, whole (a DTensor gathered)."""
    return _whole(t).cpu().numpy()


def _whole(t):
    return t.full_tensor() if is_dtensor(t) else t


class RequestError(ValueError):
    """Base class for typed request-lifecycle failures."""


class AdmissionError(RequestError):
    """The request failed admission validation (rid, prompt or budget)."""


class QueueFullError(RequestError):
    """The admission queue is at ``queue_cap``: rejected, not queued."""


#: Every request ends in exactly one of these (``BatchingStats.statuses``).
REQUEST_STATUSES = ("done", "timeout", "rejected", "failed", "retried")


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` (plen,) integer token ids and the
    number of tokens to generate (``gen_len`` >= 1; the first comes from
    the prefill's last logits).  ``deadline_s`` is an optional wall-clock
    budget from enqueue, enforced at segment boundaries; ``max_tokens``
    optionally caps the output below ``gen_len``."""
    rid: int
    prompt: np.ndarray
    gen_len: int
    deadline_s: Optional[float] = None
    max_tokens: Optional[int] = None

    @property
    def budget(self) -> int:
        """Effective generation budget: ``min(gen_len, max_tokens)``."""
        if self.max_tokens is None:
            return self.gen_len
        return min(self.gen_len, self.max_tokens)


@dataclasses.dataclass
class BatchingStats:
    """A run's summary.  ``outputs`` maps rid -> generated tokens (the
    budget's length for finished requests, partial for timeouts and
    failures); ``completed_tokens`` counts the tokens of requests that
    finished (``done``/``retried``); ``decode_steps`` the decode steps run
    (segments x segment length); ``statuses`` every rid's terminal status;
    ``reject_reasons`` the typed error of rejected or failed rids;
    ``telemetry`` the last segment's concentration summary over live rows
    (empty without LLN state).

    Speculative pools (``spec_k >= 1``): ``verify_iters`` counts the
    draft / verify iterations that emitted, ``drafted_tokens`` is
    ``spec_k * verify_iters``, ``accepted_tokens`` the accepted drafts (not
    the bonus or resampled token each iteration adds), so
    ``acceptance_rate`` is the drafts' hit rate, and
    ``goodput_tokens_per_iter`` the emitted tokens per iteration, in [1,
    spec_k + 1].  ``request_acceptance`` maps each rid to its (accepted,
    drafted) counts."""
    outputs: dict
    completed_tokens: int
    decode_steps: int
    segments: int
    admitted: int
    wall_s: float
    statuses: dict = dataclasses.field(default_factory=dict)
    reject_reasons: dict = dataclasses.field(default_factory=dict)
    recoveries: int = 0
    retries: int = 0
    timeouts: int = 0
    rejected: int = 0
    failed: int = 0
    health_events: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)
    segment_ewma_s: float = 0.0
    snapshots: int = 0
    restored_step: Optional[int] = None
    telemetry: dict = dataclasses.field(default_factory=dict)
    spec_k: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    acceptance_rate: float = 0.0
    verify_iters: int = 0
    goodput_tokens_per_iter: float = 0.0
    request_acceptance: dict = dataclasses.field(default_factory=dict)


def synthetic_traffic(n_requests: int, vocab: int, prompt_lens,
                      gen_lens, seed: int = 0) -> list[Request]:
    """Mixed-length synthetic traffic: prompts and budgets drawn round-robin
    from the given menus, tokens from a seeded numpy generator (the
    reference's stream, token for token)."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n_requests):
        plen = int(prompt_lens[i % len(prompt_lens)])
        glen = int(gen_lens[i % len(gen_lens)])
        prompt = rng.randint(0, vocab, size=(plen,)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, gen_len=glen))
    return reqs


@dataclasses.dataclass
class _Tracked:
    """Host-side lifecycle record of one accepted request."""
    req: Request
    deadline_at: Optional[float] = None   # absolute time.monotonic() bound
    retries: int = 0
    eligible_seg: int = 0                 # backoff: earliest admit boundary
    # What a quarantine recovery replays: the prompts of the prefill that
    # admitted the request (G, plen) and its row there, then per committed
    # step its inputs (E tokens) and how many of them it committed.
    group: Optional[np.ndarray] = None
    row: int = 0
    steps: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _RunState:
    """Everything one :meth:`ContinuousBatcher.run` mutates."""
    caches: object = None
    tok: object = None
    pos: object = None
    remaining: object = None
    active: object = None
    generator: Optional[torch.Generator] = None
    slot_rid: np.ndarray = None
    queue: deque = dataclasses.field(default_factory=deque)
    tracked: dict = dataclasses.field(default_factory=dict)
    outputs: dict = dataclasses.field(default_factory=dict)
    statuses: dict = dataclasses.field(default_factory=dict)
    reject_reasons: dict = dataclasses.field(default_factory=dict)
    health_events: list = dataclasses.field(default_factory=list)
    segments: int = 0
    decode_steps: int = 0
    admitted: int = 0
    recoveries: int = 0
    rejected: int = 0
    snapshots: int = 0
    restored_step: Optional[int] = None
    telemetry: dict = dataclasses.field(default_factory=dict)
    emitted_tokens: int = 0
    verify_iters: int = 0
    accepted_tokens: int = 0
    drafted_tokens: int = 0
    request_acceptance: dict = dataclasses.field(default_factory=dict)


class ContinuousBatcher:
    """Drives a ``PoolSetup`` over a queue of :class:`Request` s.

        setup = make_pool_setup(cfg, slots=4, max_len=256, segment=8)
        eng = ContinuousBatcher(setup, params)
        stats = eng.run(synthetic_traffic(...))

    ``queue_cap`` bounds the admission queue; ``max_retries`` bounds the
    quarantine recoveries per request; ``snapshot_mgr`` /
    ``snapshot_every`` enable pool snapshots.
    """

    def __init__(self, setup: PoolSetup, params, *, queue_cap: int = 1024,
                 max_retries: int = 2, snapshot_mgr=None,
                 snapshot_every: int = 0):
        self.setup = setup
        self.params = params
        self.queue_cap = queue_cap
        self.max_retries = max_retries
        self.snapshot_mgr = snapshot_mgr
        self.snapshot_every = snapshot_every
        self._runs = 0
        # Grouped admission (one batched prefill for several same-length
        # prompts) is exact when prefill is independent per row: softmax,
        # fixed alpha/beta, or per-row calibration (the pool's default).
        cfg = setup.cfg
        self.group_admits = (cfg.attn_impl == "softmax"
                             or cfg.lln_fixed_ab != 0
                             or cfg.lln_per_row_calib)

    @property
    def device(self) -> torch.device:
        return self.setup.device

    # ------------------------------------------------------------------
    # Validation (the typed-rejection path).
    # ------------------------------------------------------------------

    def check_request(self, req: Request) -> None:
        """Raise :class:`AdmissionError` if this pool can never serve the
        request (rid, malformed prompt, out-of-vocab tokens, a budget past
        the pool's capacity)."""
        s = self.setup
        if req.rid < 0:
            raise AdmissionError(
                f"request rid must be >= 0 (-1 marks a free slot), "
                f"got {req.rid}")
        p = np.asarray(req.prompt)
        if p.ndim != 1 or p.shape[0] < 1:
            raise AdmissionError(
                f"request {req.rid}: prompt must be a non-empty 1-D "
                f"token array, got shape {p.shape}")
        if not np.issubdtype(p.dtype, np.integer):
            raise AdmissionError(
                f"request {req.rid}: prompt dtype {p.dtype} is not "
                "integer token ids")
        vocab = int(getattr(s.cfg, "vocab", 0) or 0)
        if vocab and (int(p.min()) < 0 or int(p.max()) >= vocab):
            raise AdmissionError(
                f"request {req.rid}: token ids outside [0, {vocab})")
        if req.gen_len < 1:
            raise AdmissionError(
                f"request {req.rid}: gen_len must be >= 1, "
                f"got {req.gen_len}")
        if req.max_tokens is not None and req.max_tokens < 1:
            raise AdmissionError(
                f"request {req.rid}: max_tokens must be >= 1, "
                f"got {req.max_tokens}")
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise AdmissionError(
                f"request {req.rid}: deadline_s must be > 0, "
                f"got {req.deadline_s}")
        # A speculative pool reserves spec_k positions of slack: a row's
        # last iteration may commit up to spec_k tokens past its budget.
        slack = s.spec_k
        if p.shape[0] + req.budget + slack > s.max_len:
            raise AdmissionError(
                f"request {req.rid}: prompt {p.shape[0]} + gen "
                f"{req.budget}" + (f" + spec slack {slack}" if slack else "")
                + f" exceeds max_len {s.max_len}")

    def _enqueue(self, st: _RunState, req: Request) -> bool:
        try:
            self.check_request(req)
            if req.rid in st.tracked or req.rid in st.outputs:
                raise AdmissionError(f"duplicate request rid {req.rid}")
            if len(st.queue) >= self.queue_cap:
                raise QueueFullError(
                    f"request {req.rid}: admission queue at cap "
                    f"{self.queue_cap}")
        except RequestError as e:
            st.rejected += 1
            rid = req.rid
            if rid >= 0 and rid not in st.tracked and rid not in st.outputs:
                st.outputs[rid] = []
                st.statuses[rid] = "rejected"
                st.reject_reasons[rid] = str(e)
            return False
        deadline = (time.monotonic() + req.deadline_s
                    if req.deadline_s is not None else None)
        tr = _Tracked(req=req, deadline_at=deadline)
        st.tracked[req.rid] = tr
        st.outputs[req.rid] = []
        st.queue.append(tr)
        return True

    # ------------------------------------------------------------------
    # Admission (fresh groups and quarantine-recovery resumes).
    # ------------------------------------------------------------------

    def _admit_all(self, st: _RunState) -> None:
        free = list(np.nonzero(st.slot_rid < 0)[0])
        while free:
            idx = next((i for i, tr in enumerate(st.queue)
                        if tr.eligible_seg <= st.segments), None)
            if idx is None:
                break
            tr = st.queue[idx]
            del st.queue[idx]
            if st.outputs[tr.req.rid]:
                # Re-queued by quarantine recovery: the request already
                # holds committed tokens; rebuild its row mid-stream.
                self._admit_resume(st, tr, int(free.pop(0)))
                continue
            group = [tr]
            plen = tr.req.prompt.shape[0]
            # Group only consecutive eligible fresh same-length prompts
            # (keeps admission order close to first come, first served).
            while (self.group_admits and idx < len(st.queue)
                   and len(group) < len(free)):
                nxt = st.queue[idx]
                if (nxt.eligible_seg > st.segments
                        or st.outputs[nxt.req.rid]
                        or nxt.req.prompt.shape[0] != plen):
                    break
                group.append(nxt)
                del st.queue[idx]
            self._admit_group(st, group, free)

    def _tokens(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows), dtype=torch.long,
                               device=self.device)

    def _admit_group(self, st: _RunState, group: list, free: list) -> None:
        s = self.setup
        plen = group[0].req.prompt.shape[0]
        prompts = np.stack([t.req.prompt for t in group])
        logits, slot_caches = s.prefill_fn(self.params, self._tokens(prompts))
        last = logits[:, -1] if logits.ndim == 3 else logits
        tok0 = _host(torch.argmax(last, -1))
        live, live_slots, live_rem = [], [], []
        for j, tr in enumerate(group):
            rid = tr.req.rid
            tr.group, tr.row = prompts, j
            st.outputs[rid].append(int(tok0[j]))
            st.admitted += 1
            if tr.req.budget <= 1:          # done at prefill; slot free
                st.statuses[rid] = "done"
                del st.tracked[rid]
                continue
            slot = int(free.pop(0))
            live.append(j)
            live_slots.append(slot)
            live_rem.append(tr.req.budget - 1)
            st.slot_rid[slot] = rid
        if not live:
            return
        if len(live) != len(group):          # drop prefill-only rows
            sel = torch.as_tensor(live, device=self.device)
            slot_caches = map_with_path(lambda _, a: _whole(a)[sel],
                                        slot_caches)
        slots = torch.as_tensor(live_slots, device=self.device)
        st.caches = s.admit_fn(st.caches, slot_caches, slots)
        st.tok[slots] = torch.as_tensor(tok0[live], dtype=st.tok.dtype,
                                        device=self.device)
        st.pos[slots] = plen
        st.remaining[slots] = torch.as_tensor(
            live_rem, dtype=st.remaining.dtype, device=self.device)
        st.active[slots] = True

    def _admit_resume(self, st: _RunState, tr: _Tracked, slot: int) -> None:
        """Rebuild a quarantined request's row from its committed steps:
        re-prefill its admission group (the same prompts in the same batch,
        so its row's prefill is bit for bit the first one), then rerun each
        recorded step on its own inputs through ``replay_fn`` (every other
        row commits 0 and stays untouched).  The replay is the original
        trajectory, the same calls at the same shapes, so the rebuilt
        state is the one the fault destroyed, bit for bit."""
        s = self.setup
        req = tr.req
        emitted = st.outputs[req.rid]
        plen = req.prompt.shape[0]
        n = len(emitted)
        _, slot_caches = s.prefill_fn(self.params, self._tokens(tr.group))
        if tr.group.shape[0] > 1:
            sel = torch.as_tensor([tr.row], device=self.device)
            slot_caches = map_with_path(lambda _, a: _whole(a)[sel],
                                        slot_caches)
        st.caches = s.admit_fn(st.caches, slot_caches, [slot])
        committed = [t for inputs, c in tr.steps for t in inputs[:c]]
        if committed != list(emitted[:-1]):
            raise RuntimeError(f"request {req.rid}: the recorded steps "
                               "commit other tokens than it emitted")
        off = 0
        for inputs, c in tr.steps:
            chunk = np.zeros((s.slots, len(inputs)), np.int64)
            chunk[slot] = inputs
            commit = torch.zeros(s.slots, dtype=torch.int32,
                                 device=self.device)
            commit[slot] = c
            pos_r = st.pos.clone()
            pos_r[slot] = plen + off
            st.caches = s.replay_fn(self.params, st.caches,
                                    self._tokens(chunk), pos_r, commit)
            off += c
        st.tok[slot] = int(emitted[-1])
        st.pos[slot] = plen + n - 1
        left = req.budget - n
        st.remaining[slot] = left
        st.active[slot] = left > 0
        st.slot_rid[slot] = req.rid
        st.recoveries += 1

    # ------------------------------------------------------------------
    # Segment-boundary bookkeeping: harvest, quarantine, deadlines, drops.
    # ------------------------------------------------------------------

    def _free_rows(self, st: _RunState, rows: list) -> None:
        """Deactivate and evict the given pool rows."""
        s = self.setup
        if not rows:
            return
        sel = torch.as_tensor(rows, device=self.device)
        st.active[sel] = False
        st.remaining[sel] = 0
        mask = torch.zeros(s.slots, dtype=torch.bool, device=self.device)
        mask[sel] = True
        st.caches = s.evict_fn(st.caches, mask)

    def _quarantine(self, st: _RunState, idx: int) -> None:
        """The sentinel fired on row ``idx``: discard the segment's tokens
        (the committed prefix stays clean), evict the row and re-queue the
        request with exponential backoff, or fail it once its retries are
        spent.  A poisoned free slot just resets."""
        rid = int(st.slot_rid[idx])
        st.health_events.append(
            {"segment": st.segments - 1, "slot": idx, "rid": rid})
        if rid < 0:
            return
        st.slot_rid[idx] = -1
        tr = st.tracked[rid]
        tr.retries += 1
        if tr.retries > self.max_retries:
            st.statuses[rid] = "failed"
            st.reject_reasons[rid] = (
                f"unhealthy state; {self.max_retries} retries exhausted")
            del st.tracked[rid]
        else:
            tr.eligible_seg = st.segments + (1 << (tr.retries - 1))
            st.queue.append(tr)

    def _harvest(self, st: _RunState, toks_h, emitted_h, active_h,
                 unhealthy_h, inputs_h) -> None:
        """``toks_h`` (S, B, E) token panel and ``emitted_h`` (S, B) int
        emission counts per step (E = 1 and counts in {0, 1} for a plain
        pool, E = spec_k + 1 for a speculative one); ``inputs_h`` (S, B, E)
        the steps' inputs, recorded per request with the count each step
        committed (its emission count) for a recovery's replay.  Each row's
        flattened stream stops at its request's budget: a speculative row's
        overshoot is committed in the cache slack but never reaches
        ``outputs``."""
        freed: list = []
        for idx in range(self.setup.slots):
            if unhealthy_h[idx]:
                self._quarantine(st, idx)
                freed.append(idx)
                continue
            rid = int(st.slot_rid[idx])
            if rid < 0:
                continue
            tr = st.tracked[rid]
            out = st.outputs[rid]
            room = tr.req.budget - len(out)
            for step in np.nonzero(emitted_h[:, idx])[0]:
                if room <= 0:
                    break
                tr.steps.append((inputs_h[step, idx].tolist(),
                                 int(emitted_h[step, idx])))
                take = toks_h[step, idx, :int(emitted_h[step, idx])][:room]
                out.extend(int(t) for t in take)
                room -= len(take)
            if not active_h[idx]:             # evict: budget spent
                st.statuses[rid] = "retried" if tr.retries else "done"
                st.slot_rid[idx] = -1
                del st.tracked[rid]
                freed.append(idx)
        self._free_rows(st, freed)

    def _agreed(self, flags: list) -> list:
        """``flags`` (one bool per slot or queued request, the same order on
        every rank) OR-ed over the mesh's ranks; as they are without a
        mesh."""
        mesh = self.setup.mesh
        if mesh is None or not flags:
            return flags
        from repro_torch.distributed.sharding import any_over_mesh
        return any_over_mesh(torch.as_tensor(flags, device=self.device),
                             mesh).tolist()

    def _sweep_deadlines(self, st: _RunState) -> None:
        now = time.monotonic()

        def passed(tr) -> bool:
            return tr.deadline_at is not None and now >= tr.deadline_at
        held = [int(r) for r in st.slot_rid]
        slot_late = self._agreed([r >= 0 and passed(st.tracked[r])
                                  for r in held])
        queue = list(st.queue)
        queue_late = self._agreed([passed(tr) for tr in queue])
        expired_rows = []
        for idx, (rid, late) in enumerate(zip(held, slot_late)):
            if late:
                st.statuses[rid] = "timeout"   # partial output kept
                st.slot_rid[idx] = -1
                del st.tracked[rid]
                expired_rows.append(idx)
        self._free_rows(st, expired_rows)
        for tr, late in zip(queue, queue_late):
            if late:
                st.queue.remove(tr)
                st.statuses[tr.req.rid] = "timeout"
                del st.tracked[tr.req.rid]

    def _drop(self, st: _RunState, rid: int) -> None:
        """A client cancel (``drop`` fault): end ``rid`` wherever it is,
        queued or in a slot, with status ``failed``."""
        if rid in st.tracked:
            tr = st.tracked[rid]
            if tr in st.queue:
                st.queue.remove(tr)
            st.statuses[rid] = "failed"
            st.reject_reasons[rid] = "dropped by client"
            del st.tracked[rid]
        rows = [i for i in range(self.setup.slots)
                if int(st.slot_rid[i]) == rid]
        for i in rows:
            st.slot_rid[i] = -1
        self._free_rows(st, rows)

    def _fire_faults(self, st: _RunState, plan: Optional[FaultPlan],
                     fired: set, kinds: tuple) -> None:
        if plan is None:
            return
        for i, ev in enumerate(plan.events):
            if i in fired or ev.kind not in kinds \
                    or ev.segment > st.segments:
                continue
            fired.add(i)
            if ev.kind == "kill":
                raise SimulatedCrash(st.segments)
            if ev.kind == "drop":
                self._drop(st, ev.rid)
            elif ev.kind == "delay":
                time.sleep(ev.seconds)
            elif ev.kind == "nan":
                row = plan.pick_row(ev, self.setup.slots,
                                    active=st.slot_rid >= 0)
                st.caches = poison_rows(st.caches, [row])

    # ------------------------------------------------------------------
    # Snapshot / restore.
    # ------------------------------------------------------------------

    @staticmethod
    def _ser_tracked(tr: _Tracked, now: float) -> dict:
        return {"rid": tr.req.rid,
                "prompt": np.asarray(tr.req.prompt).tolist(),
                "gen_len": tr.req.gen_len,
                "max_tokens": tr.req.max_tokens,
                "deadline_left": (tr.deadline_at - now
                                  if tr.deadline_at is not None else None),
                "retries": tr.retries,
                "eligible_seg": tr.eligible_seg,
                "group": (tr.group.tolist() if tr.group is not None
                          else None),
                "row": tr.row, "steps": tr.steps}

    @staticmethod
    def _deser_tracked(entry: dict, now: float) -> _Tracked:
        req = Request(rid=int(entry["rid"]),
                      prompt=np.asarray(entry["prompt"], np.int32),
                      gen_len=int(entry["gen_len"]),
                      max_tokens=entry.get("max_tokens"))
        left = entry.get("deadline_left")
        return _Tracked(req=req,
                        deadline_at=(now + left if left is not None
                                     else None),
                        retries=int(entry.get("retries", 0)),
                        eligible_seg=int(entry.get("eligible_seg", 0)),
                        group=(np.asarray(entry["group"], np.int32)
                               if entry.get("group") is not None else None),
                        row=int(entry.get("row", 0)),
                        steps=[(list(i), int(c))
                               for i, c in entry.get("steps", [])])

    @staticmethod
    def _generator_state(gen: Optional[torch.Generator]) -> torch.Tensor:
        return (gen.get_state() if gen is not None
                else torch.zeros(0, dtype=torch.uint8))

    def _snapshot(self, st: _RunState) -> None:
        """Atomic pool snapshot: the device carry through the checkpointer
        (CRC-checked shards) and the host metadata as a JSON sidecar in the
        same committed step directory, so a restore sees both or
        neither."""
        now = time.monotonic()
        tree = {"caches": st.caches, "tok": st.tok, "pos": st.pos,
                "remaining": st.remaining, "active": st.active,
                "key": self._generator_state(st.generator)}
        queued_rids = [tr.req.rid for tr in st.queue]
        meta = {
            "slot_rid": [int(r) for r in st.slot_rid],
            "segments": st.segments, "decode_steps": st.decode_steps,
            "admitted": st.admitted, "recoveries": st.recoveries,
            "rejected": st.rejected, "snapshots": st.snapshots,
            "emitted_tokens": st.emitted_tokens,
            "verify_iters": st.verify_iters,
            "accepted_tokens": st.accepted_tokens,
            "drafted_tokens": st.drafted_tokens,
            "request_acceptance": {str(r): v for r, v
                                   in st.request_acceptance.items()},
            "queue": [self._ser_tracked(tr, now) for tr in st.queue],
            "resident": [self._ser_tracked(tr, now)
                         for rid, tr in st.tracked.items()
                         if rid not in queued_rids],
            "outputs": {str(r): list(t) for r, t in st.outputs.items()},
            "statuses": {str(r): v for r, v in st.statuses.items()},
            "reject_reasons": {str(r): v
                               for r, v in st.reject_reasons.items()},
            "health_events": st.health_events,
        }
        self.snapshot_mgr.save_now(st.segments, tree,
                                   extra={"batcher.json": json.dumps(meta)})
        st.snapshots += 1

    def _restore(self, st: _RunState,
                 generator: Optional[torch.Generator]) -> None:
        if self.snapshot_mgr is None:
            raise RuntimeError("resume=True requires a snapshot_mgr")
        step = self.snapshot_mgr.latest_step()
        if step is None:
            raise RuntimeError(
                f"resume=True but no restorable snapshot in "
                f"{self.snapshot_mgr.directory}")
        s = self.setup
        st.generator = generator
        template = {"caches": s.cache_init(), **self._carry(),
                    "key": self._generator_state(generator)}
        tree = _restore_tree(self.snapshot_mgr.directory, step, template)
        meta = json.loads(
            self.snapshot_mgr.read_extra(step, "batcher.json"))
        st.caches, st.tok, st.pos = tree["caches"], tree["tok"], tree["pos"]
        st.remaining, st.active = tree["remaining"], tree["active"]
        if generator is not None:
            generator.set_state(tree["key"])
        st.slot_rid = np.asarray(meta["slot_rid"], np.int64)
        st.segments = int(meta["segments"])
        st.decode_steps = int(meta["decode_steps"])
        st.admitted = int(meta["admitted"])
        st.recoveries = int(meta["recoveries"])
        st.rejected = int(meta["rejected"])
        st.snapshots = int(meta["snapshots"])
        st.emitted_tokens = int(meta.get("emitted_tokens", 0))
        st.verify_iters = int(meta.get("verify_iters", 0))
        st.accepted_tokens = int(meta.get("accepted_tokens", 0))
        st.drafted_tokens = int(meta.get("drafted_tokens", 0))
        st.request_acceptance = {
            int(r): list(v)
            for r, v in meta.get("request_acceptance", {}).items()}
        st.health_events = list(meta["health_events"])
        st.outputs = {int(r): list(t) for r, t in meta["outputs"].items()}
        st.statuses = {int(r): v for r, v in meta["statuses"].items()}
        st.reject_reasons = {int(r): v
                             for r, v in meta["reject_reasons"].items()}
        now = time.monotonic()
        for entry in meta["queue"]:
            tr = self._deser_tracked(entry, now)
            st.tracked[tr.req.rid] = tr
            st.queue.append(tr)
        for entry in meta["resident"]:
            tr = self._deser_tracked(entry, now)
            st.tracked[tr.req.rid] = tr
        st.restored_step = step

    def _carry(self) -> dict:
        """The zeroed per-slot carry: next token, position, remaining
        budget and the active mask."""
        s, dev = self.setup, self.device
        return {"tok": torch.zeros(s.slots, dtype=torch.long, device=dev),
                "pos": torch.zeros(s.slots, dtype=torch.int32, device=dev),
                "remaining": torch.zeros(s.slots, dtype=torch.int32,
                                         device=dev),
                "active": torch.zeros(s.slots, dtype=torch.bool,
                                      device=dev)}

    # ------------------------------------------------------------------
    # The serving loop.
    # ------------------------------------------------------------------

    def warmup(self, prompt_lens) -> None:
        """One small end-to-end pass (every prompt length, a budget of one
        segment and a token) so that a timed :meth:`run` finds the kernels
        built and the allocator warm.  Snapshots are off for it."""
        s = self.setup
        plens = list(dict.fromkeys(int(p) for p in prompt_lens))
        dummy = [Request(rid=i, prompt=np.zeros((p,), np.int32),
                         gen_len=max(1, min(s.segment + 1,
                                            s.max_len - p - s.spec_k)))
                 for i, p in enumerate(plens)]
        every, self.snapshot_every = self.snapshot_every, 0
        try:
            self.run(dummy)
        finally:
            self.snapshot_every = every

    @torch.inference_mode()
    def run(self, requests, generator: Optional[torch.Generator] = None,
            fault_plan: Optional[FaultPlan] = None,
            resume: bool = False) -> BatchingStats:
        """Serve ``requests`` to completion.  ``generator`` drives sampling
        (temperature > 0; greedy needs none); ``fault_plan`` injects
        scripted failures at segment boundaries; ``resume=True`` first
        restores the pool from the latest snapshot and finishes every
        in-flight request, then serves ``requests`` on top (``[]`` to just
        drain)."""
        s = self.setup
        if generator is None and s.temperature > 0:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self._runs)
        self._runs += 1
        st = _RunState()
        if resume:
            self._restore(st, generator)
        else:
            st.caches = s.cache_init()
            carry = self._carry()
            st.tok, st.pos = carry["tok"], carry["pos"]
            st.remaining, st.active = carry["remaining"], carry["active"]
            st.slot_rid = np.full((s.slots,), -1, np.int64)
            st.generator = generator
        for r in requests:
            self._enqueue(st, r)

        wd = StepWatchdog()
        fired: set = set()
        t0 = time.perf_counter()
        while st.queue or (st.slot_rid >= 0).any():
            # Kills and drops fire at the boundary, before admission: a
            # restore replays the admissions deterministically.
            self._fire_faults(st, fault_plan, fired, ("kill", "drop"))
            self._admit_all(st)
            if (st.slot_rid < 0).all():
                if st.queue:
                    # Every queued request waits out its backoff: advance
                    # the boundary clock so that it can become eligible.
                    st.segments += 1
                    continue
                break                         # all admits finished early

            wd.start()
            self._fire_faults(st, fault_plan, fired, ("delay", "nan"))
            (st.caches, st.tok, st.pos, st.remaining, st.active,
             toks, emitted, unhealthy, metrics, inputs) = s.segment_fn(
                self.params, st.caches, st.tok, st.pos, st.remaining,
                st.active, st.generator)
            # The host reads land inside the watchdog's window, so that it
            # sees the segment's wall clock, not the enqueue.  One panel
            # for both pools: a plain pool's (S, B) tokens and bool mask
            # become (S, B, 1) and {0, 1} counts.
            toks_h = _host(toks)
            if toks_h.ndim == 2:
                toks_h = toks_h[..., None]
            emitted_h = _host(emitted).astype(np.int64)
            inputs_h = _host(inputs)
            active_h = _host(st.active)
            unhealthy_h = _host(unhealthy)
            wd.stop(st.segments)
            st.segments += 1
            st.decode_steps += s.segment
            st.emitted_tokens += int(emitted_h.sum())
            if s.spec_k:
                self._count_acceptance(st, emitted_h)
            live = emitted_h.any(axis=0)          # rows that decoded here
            if metrics is not None and live.any():
                m = {k: _host(v) for k, v in metrics.items()}
                st.telemetry = {
                    "conc_drift_max": float(
                        np.max(np.abs(m["conc_drift"][live]))),
                    "log_mass_mean": float(np.mean(m["log_mass"][live])),
                    "log_mass_var_mean": float(
                        np.mean(m["log_mass_var"][live])),
                    "tau_hat_mean": float(np.mean(m["tau_hat"][live]))}

            self._harvest(st, toks_h, emitted_h, active_h, unhealthy_h,
                          inputs_h)
            self._sweep_deadlines(st)
            if (self.snapshot_mgr is not None and self.snapshot_every
                    and st.segments % self.snapshot_every == 0):
                self._snapshot(st)
        wall = time.perf_counter() - t0

        outputs = {rid: np.asarray(t, np.int32)
                   for rid, t in st.outputs.items()}
        done = sum(len(outputs[rid]) for rid, v in st.statuses.items()
                   if v in ("done", "retried"))
        by = {k: sum(1 for v in st.statuses.values() if v == k)
              for k in REQUEST_STATUSES}
        return BatchingStats(
            outputs=outputs, completed_tokens=done,
            decode_steps=st.decode_steps, segments=st.segments,
            admitted=st.admitted, wall_s=wall,
            statuses=dict(st.statuses),
            reject_reasons=dict(st.reject_reasons),
            recoveries=st.recoveries, retries=by["retried"],
            timeouts=by["timeout"], rejected=st.rejected,
            failed=by["failed"],
            health_events=list(st.health_events),
            stragglers=list(wd.anomalies),
            segment_ewma_s=wd.ewma or 0.0,
            snapshots=st.snapshots, restored_step=st.restored_step,
            telemetry=dict(st.telemetry),
            spec_k=s.spec_k, drafted_tokens=st.drafted_tokens,
            accepted_tokens=st.accepted_tokens,
            acceptance_rate=(st.accepted_tokens / st.drafted_tokens
                             if st.drafted_tokens else 0.0),
            verify_iters=st.verify_iters,
            goodput_tokens_per_iter=(st.emitted_tokens / st.verify_iters
                                     if st.verify_iters else 0.0),
            request_acceptance={r: tuple(v) for r, v
                                in st.request_acceptance.items()})

    def _count_acceptance(self, st: _RunState, emitted_h) -> None:
        """A speculative segment's counters: an iteration that emitted n
        tokens drafted ``spec_k`` and accepted n - 1 of them (the last is
        the target's correction or bonus), per run and per request."""
        k = self.setup.spec_k
        iters = emitted_h > 0
        accepted = np.maximum(emitted_h - 1, 0)
        st.verify_iters += int(iters.sum())
        st.drafted_tokens += k * int(iters.sum())
        st.accepted_tokens += int(accepted.sum())
        for idx in range(self.setup.slots):
            rid = int(st.slot_rid[idx])
            if rid < 0 or not iters[:, idx].any():
                continue
            acc = st.request_acceptance.setdefault(rid, [0, 0])
            acc[0] += int(accepted[:, idx].sum())
            acc[1] += k * int(iters[:, idx].sum())


__all__ = ["Request", "BatchingStats", "ContinuousBatcher",
           "RequestError", "AdmissionError", "QueueFullError",
           "REQUEST_STATUSES", "synthetic_traffic", "make_pool_setup",
           "PoolSetup"]
