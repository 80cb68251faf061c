"""The system under test, driven through its public exploration path.

``ExplorationDriver`` (``explore`` + ``step``) over ``BranchSession(engine,
max_batch=)`` over ``ServeEngine`` (fused path, paged KV, prefix cache).
Each request runs best-of-n: fork ``branches`` children of the prompt,
decode ``branch_tokens`` on each (the first ``greedy_branches`` greedily,
the rest sampled at ``temperature``), score each by its mean token id
(``mean_token_score``) and commit the best (first-commit-wins).  The greedy
branches are what the check compares with the reference.

The benchmark's own wrappers around ``engine.decode``, ``engine.add_request``
and the engine's two prefill passes record host timestamps and the shapes
of the work; nothing in them syncs or changes what the program computes."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchlib import traffic as T
from benchlib import weights as W
from benchlib.work import BYTES, Shape

#: the profiler's stretch in a traced window: from its opening, a third of
#: it and at most TRACE_S seconds
TRACE_S = 5.0
#: how long past the window's close the run waits for a due request's first
#: token
DRAIN_S = 60.0


def now() -> int:
    return time.perf_counter_ns()


def _key(prompt) -> Tuple[int, Tuple[int, ...]]:
    return len(prompt), tuple(prompt[-16:])


@dataclass
class Record:
    """What the wrappers and the loop saw, in host nanoseconds."""

    #: (start, end, rows, positions the rows read, distinct positions read
    #: or 0 outside a traced stretch)
    decodes: List[Tuple[int, int, int, int, int]] = field(
        default_factory=list)
    prefills: List[Tuple[int, int, int, int]] = field(default_factory=list)
    steps: List[Tuple[int, int, int]] = field(default_factory=list)
    gaps: List[Tuple[int, int]] = field(default_factory=list)
    admissions: List[Tuple[int, int]] = field(default_factory=list)
    admits: Dict[Tuple, int] = field(default_factory=dict)
    seq_turn: Dict[int, T.Turn] = field(default_factory=dict)
    last_token: Dict[int, int] = field(default_factory=dict)
    decode_ns: int = 0
    tracing: bool = False

    def spans(self) -> List[Tuple[str, int, int]]:
        """The host spans the trace's idle gaps are charged to."""
        return ([("driver.step", a, b) for a, b, _ in self.steps]
                + [("engine.decode", a, b) for a, b, *_ in self.decodes]
                + [("engine.add_request", a, b) for a, b in self.admissions]
                + [("engine.prefill." + ("suffix" if c else "dense"), a, b)
                   for a, b, c, _ in self.prefills])


def instrument(engine: Any, rec: Record) -> None:
    """Time the engine's calls from outside (instance attributes wrap the
    class's methods; the program's code is unchanged)."""
    decode, add_request = engine.decode, engine.add_request
    dense, chunk = engine._dense_prefill, engine._chunk_prefill
    kv = engine.kv

    def timed_decode(seq_ids, **kw):
        ctx = sum(kv.length(s) for s in seq_ids) + len(seq_ids)
        distinct = (distinct_positions(engine, seq_ids) + len(seq_ids)
                    if rec.tracing else 0)
        t0 = now()
        out = decode(seq_ids, **kw)
        t1 = now()
        rec.decode_ns += t1 - t0
        rec.decodes.append((t0, t1, len(seq_ids), ctx, distinct))
        for s in seq_ids:
            turn = rec.seq_turn.get(s)
            if turn is not None and not turn.first_ns:
                turn.first_ns = t1
            last = rec.last_token.get(s)
            if last is not None:
                rec.gaps.append((t1, t1 - last))
            rec.last_token[s] = t1
        return out

    def timed_add_request(prompt):
        t0 = rec.admits[_key(prompt)] = now()
        out = add_request(prompt)
        rec.admissions.append((t0, now()))
        return out

    def timed_dense(sid, tokens):
        t0 = now()
        out = dense(sid, tokens)
        rec.prefills.append((t0, now(), 0, len(tokens)))
        return out

    def timed_chunk(sid, tokens, covered):
        t0 = now()
        out = chunk(sid, tokens, covered)
        rec.prefills.append((t0, now(), covered, len(tokens) - covered))
        return out

    engine.decode = timed_decode
    engine.add_request = timed_add_request
    engine._dense_prefill = timed_dense
    engine._chunk_prefill = timed_chunk


def distinct_positions(engine: Any, seq_ids: List[int]) -> int:
    """Cached positions a decode step's rows read, each shared page (a
    fork's copy-on-write prefix, a prefix-cache hit) counted once."""
    page = engine.page_size
    bt, lens = engine.kv.dense_block_tables(seq_ids, engine.max_pages)
    full = lens // page
    cols = np.arange(bt.shape[1])[None, :]
    n = len(np.unique(bt[cols < full[:, None]])) * page
    tails: Dict[int, int] = {}
    for row, (f, ln) in enumerate(zip(full.tolist(), lens.tolist())):
        if ln % page:
            pid = int(bt[row, f])
            tails[pid] = max(tails.get(pid, 0), ln % page)
    return n + sum(tails.values())


def best_of_n_turn(rec: Record, turn: T.Turn, n: int, greedy: int,
                   temperature: float):
    """The policy of every request (the steps of ``best_of_n`` with the
    first ``greedy`` branches decoding greedily); it keeps each branch's
    tokens on ``turn`` before the commit recycles the losers."""
    from repro_torch.core.errors import BranchError
    from repro_torch.explore_ctx.context import policy_result
    from repro_torch.explore_ctx.driver import Decode, Fork
    from repro_torch.explore_ctx.scoring import mean_token_score

    def policy(ctx):
        rec.seq_turn[ctx.seq] = turn
        try:
            kids = yield Fork(ctx, n)
        except BranchError:
            kids = None
        if kids is None:
            # permanent page pressure: the unforked origin decodes
            turn.degraded = True
            yield Decode([ctx], turn.branch_tokens, temperature=temperature)
            return policy_result(ctx, committed=False, degraded=True)
        for k in kids:
            rec.seq_turn[k.seq] = turn
        turn.greedy = [i < greedy for i in range(n)]
        yield Decode(kids, turn.branch_tokens, greedy=turn.greedy,
                     temperature=temperature)
        turn.branches = [k.generated() for k in kids]
        for k in kids:
            k.score = mean_token_score(k)
        winner = max(kids, key=lambda k: k.score)
        winner.commit()
        return policy_result(ctx, score=winner.score)

    return policy


@dataclass
class Window:
    """One run's timeline and records, handed to the metric readers."""

    shape: Shape
    chips: int
    on_card: bool
    setup_s: float
    t_open: int
    t_close: int
    turns: List[T.Turn]
    rec: Record
    counters: Dict[str, float]
    #: the KV pool's pages, and the most of them held at once in the window
    #: (by live sequences or the prefix cache)
    pool_pages: int = 0
    pool_held_peak: int = 0
    stretch: Optional[Tuple[int, int]] = None
    trace: Optional[Dict[str, Any]] = None

    @property
    def window_s(self) -> float:
        return (self.t_close - self.t_open) / 1e9

    def inside(self, t: int) -> bool:
        return self.t_open <= t < self.t_close

    def in_stretch(self, t: int) -> bool:
        return self.stretch is not None and \
            self.stretch[0] <= t < self.stretch[1]

    def window_turns(self) -> List[T.Turn]:
        return [t for t in self.turns if t.in_window]


COUNTERS = ("kv.prefix_hits", "kv.prefix_misses", "kv.prefix_evictions")


def _counters(engine: Any) -> Dict[str, float]:
    m = engine.obs.metrics
    return {name: m.counter(name).value for name in COUNTERS}


def kv_pool_pages(cfg: Any, serve: Dict[str, Any]) -> int:
    """The KV pool's pages for a configuration's ``serve``:
    ``kv_pool_bytes`` is a card's, and over ``tp`` shards a card holds its
    shard's kv heads (all of them where the heads do not split)."""
    from repro_torch.distributed.sharding import kv_split

    shards = serve.get("tp", 1)
    kv_tp = shards if kv_split(cfg, shards) else 1
    per_token = cfg.kv_bytes_per_token(BYTES[cfg.dtype]) // kv_tp
    return int(serve["kv_pool_bytes"] // (serve["page_size"] * per_token))


class System:
    """The port's engine, session and driver for one cell and seed."""

    def __init__(self, config: Dict[str, Any], tp: Dict[str, Any],
                 seed: int, device: str):
        from repro_torch.api import BranchSession
        from repro_torch.configs.base import ArchConfig
        from repro_torch.distributed.mesh import serving_plan, tp_mesh
        from repro_torch.distributed.sharding import (serve_specs,
                                                      tree_map_with_path)
        from repro_torch.explore_ctx import ExplorationDriver
        from repro_torch.models.model import Model
        from repro_torch.runtime.serve_loop import ServeEngine

        self.device = device
        self.cfg = ArchConfig(**config["model"])
        self.model = Model(self.cfg)
        serve = config["serve"]
        like = self.model.init(device="meta")
        # tensor-parallel shards: 1 serves the whole tree on ``device``
        shards = serve.get("tp", 1)
        if shards == 1:
            self.weights = W.draw(like, seed, device)
            params, place = self.weights, {"device": device}
        else:
            mesh = tp_mesh(shards, device)
            plan = serving_plan(mesh)
            specs = serve_specs(self.cfg, plan, like)
            axes = tree_map_with_path(
                lambda _, spec: (spec.index(plan.tp_axis)
                                 if plan.tp_axis in spec else None), specs)
            self.weights = W.draw_shards(like, axes, plan.devices, seed)
            params = W.shard_trees(self.weights, shards)
            place = {"mesh": mesh}
        self.engine = ServeEngine(
            self.model, params, num_pages=kv_pool_pages(self.cfg, serve),
            page_size=serve["page_size"],
            max_pages_per_seq=serve["max_pages_per_seq"],
            prefix_cache=serve["prefix_cache"], seed=seed % (1 << 63),
            **place)
        self.rec = Record()
        instrument(self.engine, self.rec)
        self.session = BranchSession(self.engine, max_batch=tp["max_batch"],
                                     seed=(seed + 1) % (1 << 63))
        self.driver = ExplorationDriver(self.session)
        self.tp = tp
        self.live: Dict[Any, T.Turn] = {}
        #: the fewest free pool pages seen after a step, while not None
        self.least_free: Optional[int] = None

    def launch(self, turn: T.Turn, submit_ns: int) -> None:
        turn.submit_ns = submit_ns
        tp = self.tp
        exp = self.driver.explore(
            turn.prompt, turn.branch_tokens,
            best_of_n_turn(self.rec, turn, tp["branches"],
                           tp["greedy_branches"], tp["temperature"]))
        self.live[exp] = turn

    def step(self) -> List[T.Turn]:
        """One driver step; returns the requests it finished."""
        rec = self.rec
        d0 = rec.decode_ns
        t0 = now()
        self.driver.step()
        t1 = now()
        rec.steps.append((t0, t1, rec.decode_ns - d0))
        if self.least_free is not None:
            self.least_free = min(self.least_free,
                                  self.engine.kv.free_pages)
        done = []
        for exp in [e for e in self.live if e.done]:
            turn = self.live.pop(exp)
            turn.done_ns = t1
            turn.admit_ns = rec.admits.get(_key(turn.prompt), 0)
            if exp.error is not None:
                turn.error = repr(exp.error)
            else:
                turn.result = list(exp.result.tokens)
            done.append(turn)
        return done

    def sync(self) -> None:
        if self.device != "cpu":
            for d in self.engine.devices:
                torch.cuda.synchronize(d)

    def memory_peak(self) -> int:
        if self.device == "cpu":
            return 0
        return max(torch.cuda.max_memory_allocated(i)
                   for i in range(torch.cuda.device_count()))

    def release(self) -> Dict[str, Any]:
        """Free the program's state; the weights stay for the reference:
        the tree as drawn, over several shards a tree of
        :class:`benchlib.weights.Blocks`."""
        weights = self.weights
        self.live.clear()
        self.driver = self.session = self.engine = self.weights = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()
        return weights


def run_window(system: System, gen: T.ClosedLoop, seconds: float,
               t_start: int, chips: int, profile: Any = None) -> Window:
    """Set-up traffic, the window of ``seconds``, then the drain.
    ``profile`` (a :class:`benchlib.trace.Profiler`, in a traced run) covers
    a steady stretch of the window."""
    turns: List[T.Turn] = []
    rec = system.rec
    phase = "setup"

    def finished(done: List[T.Turn]) -> None:
        """A session submits its next turn at once."""
        for turn in done:
            nxt = (gen.next_turn(turn.session, turn.result)
                   if turn.result is not None
                   else gen.first_turn(turn.session))
            nxt.in_window = phase == "window"
            turns.append(nxt)
            system.launch(nxt, now())

    # ---- set-up: every session through one turn, so that turns are out of
    # phase when the window opens ---------------------------------------------
    for s in range(gen.sessions):
        turn = gen.first_turn(s)
        turns.append(turn)
        system.launch(turn, now())
    turned: set = set()
    while len(turned) < gen.sessions:
        done = system.step()
        turned.update(t.session for t in done)
        finished(done)
    if profile is not None:
        profile.start()
    system.sync()

    # ---- the window ------------------------------------------------------------
    t_open = now()
    t_close = t_open + int(seconds * 1e9)
    phase = "window"
    counters0 = _counters(system.engine)
    system.least_free = system.engine.kv.free_pages
    stretch = None
    prof_len = int(min(TRACE_S, seconds / 3) * 1e9)
    if profile is not None:
        stretch = [profile.mark(), 0]
        rec.tracing = True
    while now() < t_close:
        finished(system.step())
        if stretch is not None and not stretch[1] and \
                now() >= stretch[0] + prof_len:
            rec.tracing = False
            stretch[1] = profile.stop()
    if stretch is not None and not stretch[1]:
        rec.tracing = False
        stretch[1] = profile.stop()
    counters1 = _counters(system.engine)
    least_free = system.least_free
    system.least_free = None

    # ---- drain: every due request's first token, nothing new -----------------
    phase = "drain"
    limit = t_close + int(DRAIN_S * 1e9)
    while now() < limit and any(t.in_window and not t.first_ns
                                and t.error is None for t in turns):
        system.step()
    return Window(shape=Shape.of(system.cfg.__dict__), chips=chips,
                  on_card=system.device != "cpu",
                  setup_s=(t_open - t_start) / 1e9, t_open=t_open,
                  t_close=t_close, turns=turns, rec=rec,
                  counters={k: counters1[k] - counters0[k]
                            for k in counters0},
                  pool_pages=system.engine.kv.num_pages,
                  pool_held_peak=system.engine.kv.num_pages - least_free,
                  stretch=tuple(stretch) if stretch else None)
