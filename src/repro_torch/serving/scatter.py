"""Scatter-gather query tier over a sharded archive.

Port of :mod:`repro.serving.scatter`. ``ScatterConfig.device`` (default
``"cuda"``) names the torch device the shards load onto, in this process
or in each shard process; a shard process's ``stats`` reply adds the
fabric workers' ``"device"`` entry (its kernel launch counters and peak
device memory). A bit-probe shard's partial is a plain torch gather (the
reference's is plain ``jnp``); a row-probe shard serves its slice through
the engines' kernel backends.

The second horizontal axis from the roadmap (replicas × shards): where
:mod:`repro_torch.serving.router` / :mod:`repro_torch.serving.fabric` put
K copies of ONE index behind a routing policy, the
:class:`ScatterGatherRouter` puts the N PIECES of one index
(:mod:`repro_torch.index.shards`) behind a fan-out.
Every normalized request goes to ALL shards; partial answers are merged
EXACTLY — integer coverage thresholds make the merge lossless, so the
gathered result is bit-identical to one service holding the unsharded
index (asserted across engines × schemes × thetas in
tests/test_torch_shards.py).

Shard members come in two flavors, mirroring the replica tier:

* **in-process** (default): each shard is an :class:`AsyncScheduler`
  over a :class:`ShardSearchService` — N flusher threads in this
  interpreter, sharing the GIL but overlapping device dispatch.
* **procs** (``ScatterConfig(procs=True)``): each shard is a spawned
  worker process (:func:`shard_worker_main`, the fabric's worker recipe
  over :mod:`repro_torch.serving.ipc`) that mmap-boots ONLY its shard from the
  shard-set snapshot — the gateway never holds any index bytes, it
  learns geometry from the CRC-checked set manifest alone.

**Shard death** is where the two partition axes genuinely differ, and
the router refuses to blur them:

* row-probe shards (bit-sliced / cobs) own a file range. A dead shard
  means those files are unanswerable; every gathered result names them
  in ``SearchResult.missing_files`` and reports their entries of
  ``matches`` as vacuously False. Partial truth, honestly labeled.
* bit-probe shards (flat BF / rambo) own a word range — every kmer's
  probes land across ALL shards. Dropping one shard's miss counts can
  only turn misses into hits: silent false-positive inflation. The
  router fails LOUD instead: affected futures get
  :class:`ShardDeadError`. Zero futures are ever dropped either way —
  every submit resolves with a result or an exception.

Results are stamped with the shard set's ``set_version`` (the audit
trail the replica tier keeps via service versions).
"""

from __future__ import annotations

import dataclasses
import itertools
import multiprocessing
import os
import signal
import socket
import tempfile
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.index import query, shards as shards_mod
from repro_torch.index import state as state_mod
from repro_torch.obs import export as obs_export
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import ipc
from repro_torch.serving import service as service_mod
from repro_torch.serving.fabric import device_stats, load_kernels
from repro_torch.serving.scheduler import AsyncScheduler, SchedulerConfig

__all__ = [
    "ScatterConfig",
    "ScatterError",
    "ShardDeadError",
    "ShardSearchService",
    "ScatterGatherRouter",
    "shard_worker_main",
]


class ScatterError(RuntimeError):
    """A shard-set-level operation failed (boot, no live shards)."""


class ShardDeadError(ScatterError):
    """A bit-probe shard died: its word range is unanswerable, and
    answering without it would silently inflate the false-positive rate
    (a missing MISS count can only turn misses into hits)."""


@dataclasses.dataclass(frozen=True)
class ScatterConfig:
    """Scatter-tier knobs (static for the life of the router)."""

    procs: bool = False          # shard members: threads here vs processes
    service: service_mod.ServiceConfig = dataclasses.field(
        default_factory=service_mod.ServiceConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    verify: str = "eager"        # shard snapshot verify mode (store.load)
    boot_timeout_s: float = 180.0   # spawn -> ready (child re-imports torch)
    device: str = "cuda"         # torch device the shards load onto


# ---------------------------------------------------------------------------
# The per-shard service.
# ---------------------------------------------------------------------------

class ShardSearchService(service_mod.GeneSearchService):
    """One shard's serving surface — a :class:`GeneSearchService` whose
    answers are the shard's EXACT mergeable partial.

    Row-probe shards are complete engines over their file range, so the
    base class already does the right thing: local verdicts (padding,
    theta and bucketing included) that the router concatenates / ORs.
    Bit-probe shards override the bucket step with
    ``shards.partial_prober`` — per-(kmer, slot) local MISS counts,
    trimmed to the request's true kmer count — and leave the one
    coverage threshold to the router's merge. Bit-probe partials are NOT
    client-facing verdicts; only the router should consume them.
    """

    def __init__(self, spec: shards_mod.ShardSpec, shard_id: int,
                 shard: state_mod.IndexState,
                 config: Optional[service_mod.ServiceConfig] = None,
                 *, version: int = 0):
        self._spec = spec
        self._shard_id = shard_id
        if not spec.row_probe and config is not None \
                and config.kmer_cache is not None:
            raise ValueError(
                "bit-probe shard services emit partial miss counts, not "
                "membership rows — the kmer cache caches the wrong thing "
                "here; cache at the gather tier instead")
        super().__init__(shard, config, version=version)

    @property
    def shard_id(self) -> int:
        return self._shard_id

    def _runner(self, bucket: int):
        if self._spec.row_probe:
            return super()._runner(bucket)
        step = self._runners.get(bucket)
        if step is None:
            lo, hi = self._spec.shard_units(self._shard_id)
            fn = shards_mod.partial_prober(
                self._spec.meta.cfgs[0], self._spec.meta.scheme, lo, hi,
                self._spec.meta.engine == "rambo")

            def step(state, reads, valid, need):
                del valid, need   # the router thresholds after the merge
                return fn(state.words[0], reads)

            self._runners[bucket] = step
        return step

    def _finalize(self, take, bucket: int, out
                  ) -> List[service_mod.SearchResult]:
        if self._spec.row_probe:
            return super()._finalize(take, bucket, out)
        out = out.cpu().numpy()   # (max_batch, bucket, W') local misses
        return [service_mod.SearchResult(
            request_id=req.request_id,
            # trim pad kmers NOW: a pad slot has zero misses and would
            # alias a hit once partials are summed across shards
            matches=np.ascontiguousarray(out[i, :n_k]),
            file_ids=(), n_kmers=n_k, bucket=bucket,
            version=self._version)
            for i, (req, n_k) in enumerate(take)]


# ---------------------------------------------------------------------------
# The shard worker process.
# ---------------------------------------------------------------------------

def shard_worker_main(shard_id: int, socket_path: str, set_dir: str,
                      svc_cfg: service_mod.ServiceConfig,
                      sched_cfg: SchedulerConfig, verify: str,
                      flags: dict, device: str) -> None:
    """Entry point of one shard worker (``spawn`` target).

    The fabric worker's boot recipe (connect + Hello, boot barrier,
    loud-error reply, then the message loop), loading ONLY this worker's
    shard — validated against the set manifest by ``shards.load_shard``,
    so a foreign or rewritten shard dir kills the boot by name instead
    of serving wrong bits.
    """
    if flags.get("boot_fail_shard") == shard_id:
        os._exit(2)               # test hook: crash before Hello
    wire = ipc.connect(socket_path)
    wire.send(ipc.Hello(worker_id=shard_id, pid=os.getpid()))
    boot = wire.recv()            # Request(kind="replay"): the boot barrier
    assert boot.kind == "replay", boot
    dev = torch.device(device)
    try:
        load_kernels(dev)
        sm, shard = shards_mod.load_shard(
            set_dir, shard_id, mmap=True, verify=verify, device=dev)
        svc = ShardSearchService(sm.spec, shard_id, shard, svc_cfg,
                                 version=sm.set_version)
        sched = AsyncScheduler(svc, sched_cfg, replica_id=shard_id)
    except Exception as e:  # noqa: BLE001 - boot failure -> loud reply
        wire.send(ipc.Reply(boot.id, error=e))
        os._exit(3)
    wire.send(ipc.Reply(boot.id, payload="ready"))

    def _reply_when_done(mid: int, fut: Future) -> None:
        def _cb(f: Future) -> None:
            err = f.exception()
            try:
                wire.send(ipc.Reply(
                    mid, payload=None if err else f.result(), error=err))
            except ipc.WireClosed:
                pass              # gateway gone; recv loop exits on EOF
        fut.add_done_callback(_cb)

    while True:
        try:
            msg = wire.recv()
        except ipc.WireClosed:
            break                 # gateway died; nothing to serve for
        try:
            if msg.kind == "query":
                rid, read = msg.payload
                # msg.trace parents this shard's pipeline spans under the
                # router's dispatch span — same stitching as the fabric
                _reply_when_done(msg.id, sched.submit(
                    service_mod.SearchRequest(read=read, request_id=rid),
                    trace=msg.trace))
            elif msg.kind == "stats":
                wire.send(ipc.Reply(msg.id, payload={
                    "pid": os.getpid(),
                    "shard_id": shard_id,
                    "version": svc.version,
                    "compile_counts": sched.compile_counts(),
                    "obs": obs_export.snapshot(),
                    "device": device_stats(dev),
                }))
            elif msg.kind == "shutdown":
                sched.close()     # drains: zero dropped futures
                wire.send(ipc.Reply(msg.id, payload="bye"))
                break
            else:
                wire.send(ipc.Reply(msg.id, error=ValueError(
                    f"unknown request kind {msg.kind!r}")))
        except ipc.WireClosed:
            break
        except Exception as e:  # noqa: BLE001 - admission errors etc.
            try:
                wire.send(ipc.Reply(msg.id, error=e))
            except ipc.WireClosed:
                break
    wire.close()


# ---------------------------------------------------------------------------
# The gather.
# ---------------------------------------------------------------------------

class _Gather:
    """One request's fan-out: a slot per shard, merged when the last
    slot is accounted for (answer, hard error, or death)."""

    def __init__(self, router: "ScatterGatherRouter", request_id: int,
                 n_kmers: int):
        self.future: Future = Future()
        self.request_id = request_id
        self.n_kmers = n_kmers
        self.parts: Dict[int, service_mod.SearchResult] = {}
        self.lost: set = set()
        self._router = router
        self._lock = threading.Lock()
        self._sealed = False

    def _account(self) -> bool:
        """True exactly once, when every shard has landed."""
        if self._sealed:
            return False
        if len(self.parts) + len(self.lost) < self._router.n_shards:
            return False
        self._sealed = True
        return True

    def shard_done(self, shard_id: int,
                   result: service_mod.SearchResult) -> None:
        with self._lock:
            self.parts[shard_id] = result
            finish = self._account()
        if finish:
            self._finish()

    def shard_lost(self, shard_id: int) -> None:
        with self._lock:
            self.lost.add(shard_id)
            finish = self._account()
        if finish:
            self._finish()

    def shard_failed(self, shard_id: int, exc: BaseException) -> None:
        """A shard answered with a hard error (bad request reaches every
        shard identically, so one error speaks for the gather)."""
        with self._lock:
            if self._sealed:
                return
            self._sealed = True
        if not self.future.done():
            self.future.set_exception(exc)

    def _finish(self) -> None:
        try:
            self.future.set_result(self._router._merge(self))
        except Exception as e:  # noqa: BLE001 - incl. ShardDeadError
            self.future.set_exception(e)


@dataclasses.dataclass
class _Shard:
    id: int
    proc: Optional[multiprocessing.process.BaseProcess] = None
    wire: Optional[ipc.Wire] = None
    sched: Optional[AsyncScheduler] = None      # in-process member
    alive: bool = True
    retiring: bool = False    # planned shutdown: EOF is not a death
    last_error: Optional[BaseException] = None


# ---------------------------------------------------------------------------
# The router.
# ---------------------------------------------------------------------------

class ScatterGatherRouter:
    """Fan one request over every shard of a shard-set snapshot; gather
    and merge the partials exactly. ``submit`` returns a
    ``Future[SearchResult]`` stamped with the shard set's version."""

    def __init__(self, shard_set_dir: str,
                 config: Optional[ScatterConfig] = None):
        self.config = config or ScatterConfig()
        self._dir = shard_set_dir
        # O(manifest): geometry + version from the CRC-checked set
        # manifest; the gateway itself never pages shard bytes in
        sm = shards_mod.read_set_meta(shard_set_dir)
        self._set_meta = sm
        self._spec = sm.spec
        self._set_version = sm.set_version
        self._k = state_mod.kmer_size(sm.spec.meta)
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._next_rid = itertools.count()
        self._mid = itertools.count()
        # mid -> (shard_id, kind, ctx, open dispatch Span | None)
        self._pending: Dict[int, Tuple[int, str, object, object]] = {}
        self._shards: List[_Shard] = []
        self._closed = False
        self._test_flags: dict = {}
        self._listener = None
        self._rundir = None
        try:
            if self.config.procs:
                self._boot_procs()
            else:
                self._boot_threads()
        except Exception:
            self.close()
            raise

    # -- boot ----------------------------------------------------------------
    def _boot_threads(self) -> None:
        _, states = shards_mod.load_shard_set(
            self._dir, mmap=True, verify=self.config.verify,
            device=self.config.device)
        for s, st in enumerate(states):
            svc = ShardSearchService(self._spec, s, st,
                                     self.config.service,
                                     version=self._set_version)
            self._shards.append(_Shard(
                id=s, sched=AsyncScheduler(
                    svc, self.config.scheduler, replica_id=s)))

    def _boot_procs(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        # AF_UNIX paths cap at ~107 bytes; a private dir in the default
        # tmp root stays short no matter where the caller runs
        self._rundir = tempfile.mkdtemp(prefix="idl-scatter-")
        self._socket_path = os.path.join(self._rundir, "gw.sock")
        self._listener = ipc.listen(self._socket_path)
        for s in range(self._spec.n_shards):
            proc = ctx.Process(
                target=shard_worker_main,
                args=(s, self._socket_path, self._dir,
                      self.config.service, self.config.scheduler,
                      self.config.verify, dict(self._test_flags),
                      self.config.device),
                daemon=True, name=f"idl-shard-{s}")
            proc.start()
            self._shards.append(_Shard(id=s, proc=proc))
        self._hello_all()
        for sh in self._shards:   # boot barrier: load + schedule, or die
            sh.wire.send(ipc.Request(next(self._mid), "replay"))
        for sh in self._shards:
            try:
                ready = sh.wire.recv()
            except ipc.WireClosed as e:
                raise ScatterError(
                    f"shard {sh.id} died while booting from "
                    f"{self._dir!r}") from e
            if ready.error is not None:
                raise ScatterError(
                    f"shard {sh.id} failed to boot from {self._dir!r}: "
                    f"{ready.error!r}")
            threading.Thread(target=self._receiver_loop, args=(sh,),
                             daemon=True,
                             name=f"idl-scatter-recv-{sh.id}").start()

    def _hello_all(self) -> None:
        """Accept until every spawned shard said Hello (spawns overlap,
        so the fleet pays ONE interpreter boot, not N)."""
        pending = {sh.id: sh for sh in self._shards}
        deadline = time.monotonic() + self.config.boot_timeout_s
        self._listener.settimeout(0.2)
        while pending:
            for sh in pending.values():
                if not sh.proc.is_alive():
                    raise ScatterError(
                        f"shard {sh.id} died during boot "
                        f"(exit code {sh.proc.exitcode})")
            if time.monotonic() > deadline:
                raise ScatterError(
                    f"shard boot timed out after "
                    f"{self.config.boot_timeout_s}s")
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            wire = ipc.Wire(conn)
            hello = wire.recv()
            pending.pop(hello.worker_id).wire = wire

    # -- views ---------------------------------------------------------------
    @property
    def spec(self) -> shards_mod.ShardSpec:
        return self._spec

    @property
    def n_shards(self) -> int:
        return self._spec.n_shards

    @property
    def set_version(self) -> int:
        return self._set_version

    def live_shards(self) -> List[int]:
        with self._lock:
            return [sh.id for sh in self._shards if sh.alive]

    def shard_pids(self) -> Dict[int, int]:
        """Live proc shards' OS pids (fault-injection hooks for tests)."""
        with self._lock:
            return {sh.id: sh.proc.pid for sh in self._shards
                    if sh.alive and sh.proc is not None}

    def stats(self) -> Dict[int, dict]:
        """Per-shard serving stats (gathered over the wire for procs)."""
        if not self.config.procs:
            with self._lock:
                members = [(sh.id, sh.sched) for sh in self._shards
                           if sh.alive]
            return {sid: {
                "shard_id": sid,
                "version": self._set_version,
                "compile_counts": sched.compile_counts(),
            } for sid, sched in members}
        futures: List[Tuple[int, Future]] = []
        with self._lock:
            for sh in self._shards:
                if not sh.alive:
                    continue
                fut: Future = Future()
                mid = next(self._mid)
                self._pending[mid] = (sh.id, "stats", fut, None)
                futures.append((sh.id, fut))
                try:
                    sh.wire.send(ipc.Request(mid, "stats"))
                except ipc.WireClosed:
                    pass          # death lands via the receiver thread
        out = {}
        for sid, fut in futures:
            try:
                out[sid] = fut.result(timeout=30)
            except Exception:  # noqa: BLE001 - died mid-gather: skip it
                pass
        return out

    def obs_snapshot(self) -> dict:
        """Fleet obs view. In-process shard members already feed this
        process's registry, so the local snapshot is the whole story;
        proc members ship their snapshots on the ``stats`` reply and the
        merge stitches their spans under the router's dispatch spans."""
        local = obs_export.snapshot()
        if not self.config.procs:
            return local
        per = self.stats()
        return obs_export.merge(
            [local] + [s["obs"] for s in per.values()
                       if isinstance(s, dict) and s.get("obs")])

    # -- admission -----------------------------------------------------------
    def submit(self, request) -> Future:
        """Fan one read to every live shard; Future[SearchResult].

        Admission mints the trace id: the router's root span covers the
        whole scatter-gather (closed when the gathered future resolves),
        one ``shard_exec`` child per dispatch, and — for proc shards —
        the shard's own pipeline spans stitch under that child across the
        process boundary.
        """
        req, n_kmers = service_mod.normalize_request(request, self._k)
        rid = req.request_id
        if rid is None:
            rid = next(self._next_rid)
        req = service_mod.SearchRequest(read=req.read, request_id=rid)
        g = _Gather(self, rid, n_kmers)
        trc = obs_trace.DEFAULT
        ctx = None
        if trc.enabled:
            root = trc.start("request", tier="scatter", rid=rid)
            ctx = root.context()
            g.future.add_done_callback(lambda f: root.end(
                status="error" if (f.cancelled() or f.exception())
                else "ok"))
        with self._lock:
            if self._closed:
                raise ScatterError("scatter router is closed")
            members = list(self._shards)
        if not any(sh.alive for sh in members):
            raise ScatterError("scatter router has no live shards")
        for sh in members:
            if not sh.alive:
                g.shard_lost(sh.id)
            elif sh.sched is not None:
                self._dispatch_local(sh, g, req, trace=ctx)
            else:
                self._dispatch_proc(sh, g, req, trace=ctx)
        return g.future

    def search(self, reads) -> List[service_mod.SearchResult]:
        """Synchronous convenience: submit all, results in order."""
        return [f.result() for f in [self.submit(r) for r in reads]]

    def _dispatch_local(self, sh: _Shard, g: _Gather,
                        req: service_mod.SearchRequest, *,
                        trace=None) -> None:
        def _cb(f: Future) -> None:
            err = f.exception()
            if err is not None:
                g.shard_failed(sh.id, err)
            else:
                g.shard_done(sh.id, f.result())
        try:
            sh.sched.submit(req, trace=trace).add_done_callback(_cb)
        except Exception as e:  # noqa: BLE001 - closed scheduler = dead
            g.shard_lost(sh.id) if isinstance(e, RuntimeError) \
                else g.shard_failed(sh.id, e)

    def _dispatch_proc(self, sh: _Shard, g: _Gather,
                       req: service_mod.SearchRequest, *,
                       trace=None) -> None:
        trc = obs_trace.DEFAULT
        span = (trc.start("shard_exec", trace=trace, shard=sh.id,
                          rid=req.request_id)
                if trc.enabled and trace is not None else None)
        with self._lock:
            if not sh.alive:
                if span is not None:
                    span.end(status="error", error="shard dead")
                g.shard_lost(sh.id)
                return
            mid = next(self._mid)
            self._pending[mid] = (sh.id, "query", g, span)
        try:
            sh.wire.send(ipc.Request(
                mid, "query", (req.request_id, req.read),
                trace=None if span is None else span.context()))
        except ipc.WireClosed:
            with self._lock:
                self._pending.pop(mid, None)
            if span is not None:
                span.end(status="error", error=f"shard {sh.id} died")
            self._on_shard_death(sh)
            g.shard_lost(sh.id)

    # -- gather --------------------------------------------------------------
    def _receiver_loop(self, sh: _Shard) -> None:
        while True:
            try:
                msg = sh.wire.recv()
            except Exception:  # noqa: BLE001 - any wire failure is death
                self._on_shard_death(sh)
                return
            if msg.id == -1:          # unsolicited fatal shard error
                sh.last_error = msg.error
                continue
            with self._lock:
                entry = self._pending.pop(msg.id, None)
                self._idle.notify_all()
            if entry is None:
                continue
            _, kind, ctx, span = entry
            if span is not None:
                span.end(status="ok" if msg.error is None else "error")
            if kind == "query":
                if msg.error is not None:
                    ctx.shard_failed(sh.id, msg.error)
                else:
                    ctx.shard_done(sh.id, msg.payload)
            elif msg.error is not None:
                ctx.set_exception(msg.error)
            else:
                ctx.set_result(msg.payload)

    def _on_shard_death(self, sh: _Shard) -> None:
        with self._lock:
            if not sh.alive:
                return
            sh.alive = False
            was_planned = sh.retiring
            orphaned = [(mid, e) for mid, e in self._pending.items()
                        if e[0] == sh.id]
            for mid, _ in orphaned:
                del self._pending[mid]
            self._idle.notify_all()
        try:
            sh.wire.close()
        except Exception:  # noqa: BLE001 - already dead
            pass
        if sh.proc is not None and not sh.proc.is_alive():
            sh.proc.join(timeout=1)   # reap, don't leave a zombie
        # orphaned dispatch spans close with ERROR — a kill -9'd shard's
        # in-flight work must show up in the trace, not leak open
        for _, (_, _, _, span) in orphaned:
            if span is not None:
                span.end(status="error", error=f"shard {sh.id} died")
        for _, (_, kind, ctx, _) in orphaned:
            if kind == "query":
                # no re-route exists: this shard held the ONLY copy of
                # its partition. The gather decides what its death means
                # (missing_files vs ShardDeadError) at merge time.
                ctx.shard_lost(sh.id)
            elif was_planned:
                if not ctx.done():
                    ctx.set_result(None)
            else:
                ctx.set_exception(ScatterError(
                    f"shard {sh.id} died before answering a {kind!r} "
                    f"request"))

    def _merge(self, g: _Gather) -> service_mod.SearchResult:
        """Combine per-shard partials into the oracle's exact answer."""
        spec, meta = self._spec, self._spec.meta
        bucket = service_mod.bucket_for(
            g.n_kmers, self.config.service.min_bucket_kmers)
        missing: Tuple[int, ...] = ()
        if spec.row_probe:
            matches = np.zeros(int(meta.n_files), dtype=bool)
            if meta.engine == "bitsliced":
                for s, res in g.parts.items():
                    owned = shards_mod.shard_files(spec, s)
                    row = np.asarray(res.matches, dtype=bool)
                    matches[owned[0]:owned[0] + len(owned)] = \
                        row[:len(owned)]
            else:                     # cobs: OR over disjoint file sets
                for res in g.parts.values():
                    matches |= np.asarray(res.matches, dtype=bool)
            missing = tuple(sorted(
                f for s in g.lost for f in shards_mod.shard_files(spec, s)))
            fids = tuple(int(f) for f in np.nonzero(matches)[0])
        else:
            if g.lost:
                dead = sorted(g.lost)
                ranges = [spec.shard_units(s) for s in dead]
                raise ShardDeadError(
                    f"bit-probe shard(s) {dead} (word ranges {ranges}) "
                    f"died; their probes are unanswerable — failing loud "
                    f"instead of silently inflating the FPR")
            total = None              # (n_k, W') summed miss counts
            for s in range(spec.n_shards):
                part = np.asarray(g.parts[s].matches, dtype=np.int64)
                total = part if total is None else total + part
            member = total == 0       # a hit is zero misses ANYWHERE
            need = query.coverage_need(
                self.config.service.theta, g.n_kmers)
            if meta.engine == "bloom":
                hit = int(member[:, 0].sum()) >= need
                matches = np.bool_(hit)
                fids = (0,) if hit else ()
            else:                     # rambo: bucket grid -> per-file AND
                grid = member.reshape(g.n_kmers, meta.n_rep,
                                      meta.n_buckets)
                asn = shards_mod.rambo_file_assignment(meta)   # (R, N)
                per_rep = grid[:, np.arange(meta.n_rep)[:, None], asn]
                matches = per_rep.all(axis=1).sum(axis=0) >= need
                fids = tuple(int(f) for f in np.nonzero(matches)[0])
        return service_mod.SearchResult(
            request_id=g.request_id, matches=matches, file_ids=fids,
            n_kmers=g.n_kmers, bucket=bucket, version=self._set_version,
            missing_files=missing)

    # -- fault injection / lifecycle -----------------------------------------
    def kill_shard(self, shard_id: int) -> None:
        """Take one shard down (test/ops hook). Proc shards are SIGKILLed
        — their in-flight gathers see a real mid-stream death. In-process
        shards retire gracefully (their scheduler drains first), then
        stop receiving traffic."""
        with self._lock:
            sh = self._shards[shard_id]
        if sh.proc is not None:
            os.kill(sh.proc.pid, signal.SIGKILL)
            return
        with self._lock:
            if not sh.alive:
                return
            sh.alive = False
        sh.sched.close()              # drains: zero dropped futures

    def drain(self) -> None:
        """Block until every in-flight request has its reply."""
        with self._lock:
            members = [sh.sched for sh in self._shards
                       if sh.alive and sh.sched is not None]
        for sched in members:
            sched.drain()
        with self._idle:
            while self._pending:
                self._idle.wait(timeout=1.0)

    def _shutdown_proc(self, sh: _Shard) -> None:
        sh.retiring = True
        fut: Future = Future()
        with self._lock:
            mid = next(self._mid)
            self._pending[mid] = (sh.id, "shutdown", fut, None)
        try:
            sh.wire.send(ipc.Request(mid, "shutdown"))
            fut.result(timeout=60)
        except Exception:  # noqa: BLE001 - escalate to terminate below
            with self._lock:
                self._pending.pop(mid, None)
                self._idle.notify_all()
        sh.proc.join(timeout=10)
        if sh.proc.is_alive():
            sh.proc.terminate()
            sh.proc.join(timeout=10)
        with self._lock:
            sh.alive = False

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            members = [sh for sh in self._shards if sh.alive]
        for sh in members:
            if sh.sched is not None:
                sh.sched.close()
            elif sh.wire is not None:
                self._shutdown_proc(sh)
            elif sh.proc is not None:
                sh.retiring = True
                sh.proc.terminate()
                sh.proc.join(timeout=10)
        if self._listener is not None:
            self._listener.close()
        if self._rundir is not None:
            try:
                os.unlink(self._socket_path)
                os.rmdir(self._rundir)
            except OSError:
                pass

    def __enter__(self) -> "ScatterGatherRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
