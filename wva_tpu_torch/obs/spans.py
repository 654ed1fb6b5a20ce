"""In-process hierarchical span recorder for the fleet tick
(docs/design/observability.md; the port's trees and profiler ranges:
``wva_tpu_torch/obs/SPANS.md``).

Every engine tick opens one **tick span**; the engine's phase boundaries,
per-model prepare/analyze, the fused device dispatch, the grouped
collector's backend queries, capacity provisioning orders, and actuation
status writes all nest under it — so a slow tick decomposes into exactly
the tree of work it performed, with monotonic durations and world-clock
timestamps. Shard workers record their own subtree and stamp it (fleet
tick id, shard id) into their :class:`~wva_tpu_torch.shard.summary.ShardCapture`;
the fleet shard grafts every worker's subtree under its own tick span, so
a 4-shard fleet tick is still ONE trace.

Discipline (the same one the decision flight recorder lives by):

- **Out-of-band.** Spans observe; they never influence. ``WVA_SPANS=off``
  (and on) leaves statuses, DecisionTrace cycles, and every replay golden
  byte-identical — the lever gates only whether this recorder exists.
- **Never bite.** Every hook is exception-wrapped; a serialization error
  is a counted drop, not a failed engine tick.
- **Bounded.** Completed tick trees land in a bounded ring (readable via
  :meth:`SpanRecorder.snapshot`); the optional JSONL spill rides a
  bounded-queue writer thread exactly like ``blackbox/recorder.py`` — a
  hung disk drops records (counted), never stalls the tick loop.

Ids are deterministic: the trace id is ``t<tick seq>`` and span ids are
allocated in creation order (``s1``, ``s2``, ...), so a replayed
single-threaded world produces the identical tree. Timestamps pair the
injectable world clock (``utils/clock`` — comparable across processes and
meaningful in simulation) with ``time.perf_counter()`` monotonic
durations (immune to world-clock jumps).

**One clock with the device trace.** When a torch profiler is recording
as a root opens, every span begun on the root's own thread also opens a
profiler range named ``wva:<span name>``, closed where the span closes,
so the tree lands on the profiler's timeline beside the kernels it
launched. The ranges are function-scoped: the profiler does not mirror
them onto the device's timeline. Spans of other threads stay in the tree
but are not mirrored (ranges of one thread nest), and so do the leaves
named in ``TREE_ONLY``: their parent's range holds their time. A range
closes every range opened inside it that is still open, so the ranges
nest even where an exception left a stage open. With no profiler
recording, a span pays one boolean test for this.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import sys
import threading
import time
from contextlib import nullcontext

from wva_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock

log = logging.getLogger(__name__)

SPAN_SCHEMA_VERSION = 1

# Writer-thread handoff bound (same rationale as the flight recorder's).
SPILL_QUEUE_SIZE = 256

DROP_REASON_RING_EVICTED = "ring-evicted"
DROP_REASON_WRITE_ERROR = "write-error"
DROP_REASON_WRITE_BACKLOG = "write-backlog"
DROP_REASON_ENCODE_ERROR = "encode-error"
DROP_REASON_NO_TICK = "no-open-tick"

# Keep at most this many slow-tick dump files per process (oldest pruned).
MAX_SLOW_DUMPS = 20

# Prefix of the profiler ranges that mirror spans.
RANGE_PREFIX = "wva:"

# Spans kept in the tree but given no profiler range: each backend query
# (about 20 a tick for one model) and the innermost parts of the launch
# paths (the fused program's, the EKF step's h and H).
# Inside a real tick under the profiler a range costs some 5 us of host
# time to open and close, several times its cost alone, so the ranges
# stop at the spans that hold these; the parent's range carries their
# time on the profiler's clock.
TREE_ONLY = frozenset({"backend_query", "launch", "readback", "materialize",
                       "h_jacobian"})


def scoped(spans: "SpanRecorder | None", name: str, **attrs):
    """``spans.span(name, **attrs)``, or a context that records nothing
    without a recorder (callers that take an optional ``spans``)."""
    if spans is None:
        return nullcontext()
    return spans.span(name, **attrs)


def _profiler_recording() -> bool:
    """Whether a torch profiler is recording in this process (False when
    torch was never imported: then none can be)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch._C._autograd._profiler_enabled())
    except Exception:  # noqa: BLE001 — observability must not bite
        return False


class Span:
    """One node of a tick tree. Slotted and dict-free when attribute-less:
    the quiet-tick overhead budget is single-digit microseconds per span."""

    __slots__ = ("span_id", "name", "ts", "dur_ms", "attrs", "children",
                 "_t0", "_range")

    def __init__(self, span_id: str, name: str, ts: float,
                 attrs: dict | None) -> None:
        self.span_id = span_id
        self.name = name
        self.ts = ts            # world clock (utils/clock) at start
        self.dur_ms = 0.0       # perf_counter-derived, monotonic
        self.attrs = attrs
        self.children: list[Span] = []
        self._t0 = time.perf_counter()
        # The open profiler range mirroring this span, if any.
        self._range = None

    def to_dict(self) -> dict:
        d: dict = {"span_id": self.span_id, "name": self.name,
                   "ts": round(self.ts, 6), "dur_ms": round(self.dur_ms, 3)}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class _SpanCtx:
    """Context-manager handle: pushes the span on the recorder's
    thread-local stack so nested ``span()`` calls parent correctly, pops
    and closes on exit. Exceptions propagate (spans observe, they never
    swallow) but the span still closes."""

    __slots__ = ("_rec", "span")

    def __init__(self, rec: "SpanRecorder", span: Span | None) -> None:
        self._rec = rec
        self.span = span

    def __enter__(self) -> Span | None:
        if self.span is not None:
            self._rec._push(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.span is not None:
            self._rec._pop(self.span)
        return None


class SpanRecorder:
    """Tick-scoped span tree builder. All methods are thread-safe (the
    per-model analysis pool and the grouped collector's warm pool record
    from worker threads) and exception-safe."""

    def __init__(self, clock: Clock | None = None, ring_size: int = 64,
                 spill_path: str | None = None, slow_tick_ms: float = 0.0,
                 slow_dump_dir: str = "", otlp_endpoint: str = "",
                 registry=None, engine: str = "") -> None:
        self.clock = clock or SYSTEM_CLOCK
        self._mu = threading.Lock()
        self._local = threading.local()
        self.ring: list[dict] = []
        self.ring_size = max(int(ring_size), 1)
        self.spill_path = spill_path
        self.slow_tick_ms = float(slow_tick_ms)
        self.slow_dump_dir = slow_dump_dir
        self.otlp_endpoint = otlp_endpoint
        # MetricsRegistry (duck-typed): observe_span_tick / observe_span_drop
        # / observe_slow_tick_dump / observe_otlp_export. None = counters only.
        self.registry = registry
        self.engine = engine
        self._tick_seq = 0
        self._span_seq = 0
        self._root: Span | None = None
        # Cross-thread fallback parent (the engine's current phase span):
        # spans recorded from helper threads with an empty local stack
        # attribute to the phase that spawned the work, not the bare root.
        self._default_parent: Span | None = None
        self._trace_id = ""
        # Adopted context for shard-worker recorders: the fleet stamps
        # (fleet trace id, shard id) here before driving the worker tick.
        self._adopted: tuple[str, int] | None = None
        self._last_tree: dict | None = None
        # Profiler mirroring, decided once per root: the range type while
        # a profiler records (else None), the root's thread, and the
        # mirrored spans whose ranges are still open.
        self._mirror = None
        self._root_thread = 0
        self._ranges: list[Span] = []
        self.ticks_total = 0
        self.dropped_total = 0
        self.slow_dumps_total = 0
        self._slow_dump_paths: list[str] = []
        self._spill_queue: queue.Queue | None = None
        self._spill_mu = threading.Lock()
        self._spill_file = None
        self._otlp = None
        if self.spill_path:
            self._spill_queue = queue.Queue(maxsize=SPILL_QUEUE_SIZE)
            threading.Thread(target=self._writer_loop,
                             name="span-spill-writer", daemon=True).start()
        if self.otlp_endpoint:
            from wva_tpu_torch.obs.otlp import OtlpExporter

            self._otlp = OtlpExporter(self.otlp_endpoint,
                                      registry=registry)

    # --- tick lifecycle (engine.optimize) ---

    def adopt(self, trace_id: str, shard_id: int) -> None:
        """Shard-worker entry: the next tick records under the FLEET's
        trace id, stamped with this worker's shard id — the span context
        the worker ships in its ShardCapture."""
        with self._mu:
            self._adopted = (trace_id, int(shard_id))

    def begin_tick(self, engine: str = "", **attrs) -> Span:
        mirror = (sys.modules["torch"]._C._profiler._RecordFunctionFast
                  if _profiler_recording() else None)
        with self._mu:
            self._tick_seq += 1
            self._span_seq = 0
            adopted = self._adopted
            self._adopted = None
            if adopted is not None:
                self._trace_id = adopted[0]
                attrs = {**attrs, "shard": adopted[1]}
                name = "shard_tick"
            else:
                self._trace_id = f"t{self._tick_seq:08d}"
                name = "tick"
            attrs = {**attrs, "engine": engine or self.engine}
            self._span_seq += 1
            root = Span(f"s{self._span_seq}", name, self.clock.now(), attrs)
            self._root = root
            self._default_parent = None
            self._close_ranges()
            self._mirror = mirror
            self._root_thread = threading.get_ident()
            if mirror is not None:
                self._open_range(root)
        # The engine thread's stack starts at the root; worker threads
        # fall back to the root when their local stack is empty.
        self._stack().clear()
        return root

    def end_tick(self, outcome: str = "success") -> dict | None:
        """Close the tick tree, commit it to the ring (+ spill / OTLP),
        run the slow-tick check. Returns the committed tree dict."""
        with self._mu:
            root = self._root
            self._root = None
            self._default_parent = None
            if root is None:
                return None
            root.dur_ms = (time.perf_counter() - root._t0) * 1000.0
            self._close_ranges()
            tree = {
                "schema": SPAN_SCHEMA_VERSION,
                "trace_id": self._trace_id,
                "outcome": outcome,
                **root.to_dict(),
            }
            self._last_tree = tree
            if len(self.ring) >= self.ring_size:
                self.ring.pop(0)
                if not self.spill_path:
                    self._drop_locked(DROP_REASON_RING_EVICTED)
            self.ring.append(tree)
            self.ticks_total += 1
        self._stack().clear()
        if self.registry is not None:
            try:
                self.registry.observe_span_tick(tree["attrs"].get(
                    "engine", ""))
            except Exception:  # noqa: BLE001 — observability must not bite
                pass
        self._spill(tree)
        if self._otlp is not None:
            self._otlp.submit(tree)
        if self.slow_tick_ms > 0 and root.dur_ms >= self.slow_tick_ms:
            self.dump_last(reason="slow-tick")
        return tree

    def abandon_tick(self) -> None:
        """Drop the open tick tree without committing (tick retried: the
        failed attempt's spans must not stack under the retry's)."""
        with self._mu:
            self._root = None
            self._close_ranges()
        self._stack().clear()

    # --- span creation (engine, collector, capacity, actuation) ---

    def span(self, name: str, parent: Span | None = None,
             **attrs) -> _SpanCtx:
        """Scoped child span. Parent resolution: explicit ``parent`` >
        the calling thread's innermost open span > the tick root. Outside
        a tick the context records nothing (a no-op handle)."""
        return _SpanCtx(self, self.begin_span(name, parent=parent, **attrs))

    def begin_span(self, name: str, parent: Span | None = None,
                   **attrs) -> Span | None:
        with self._mu:
            if self._root is None:
                self._drop_locked(DROP_REASON_NO_TICK)
                return None
            if parent is None:
                stack = self._stack()
                parent = (stack[-1] if stack
                          else self._default_parent or self._root)
            self._span_seq += 1
            span = Span(f"s{self._span_seq}", name, self.clock.now(),
                        attrs or None)
            parent.children.append(span)
            if (self._mirror is not None and name not in TREE_ONLY
                    and threading.get_ident() == self._root_thread):
                self._open_range(span)
            return span

    def end_span(self, span: Span | None, **attrs) -> None:
        if span is None:
            return
        span.dur_ms = (time.perf_counter() - span._t0) * 1000.0
        if span._range is not None:
            self._close_range(span)
        if attrs:
            span.attrs = {**(span.attrs or {}), **attrs}

    def annotate(self, span: Span | None, **attrs) -> None:
        if span is not None and attrs:
            span.attrs = {**(span.attrs or {}), **attrs}

    def set_default_parent(self, span: Span | None) -> None:
        """Install the cross-thread fallback parent (the engine's current
        phase span); None restores the tick root."""
        with self._mu:
            self._default_parent = span

    # --- cross-process stitching (shard plane) ---

    def take_capture_spans(self) -> tuple[list[dict], list]:
        """Shard-worker side: hand the just-committed worker tick tree to
        the ShardCapture, stamped with the (fleet tick id, shard id)
        context it recorded under. Clears the handoff slot."""
        with self._mu:
            tree = self._last_tree
            self._last_tree = None
        if tree is None:
            return [], []
        shard = (tree.get("attrs") or {}).get("shard", -1)
        return [tree], [tree.get("trace_id", ""), shard]

    def graft(self, trees: list[dict], parent: Span | None = None) -> None:
        """Fleet side: attach worker subtrees under the open tick span,
        re-stamped with the fleet trace id and shard-namespaced span ids
        (``sh<id>:s1``) so ids stay unique within the stitched trace."""
        if not trees:
            return
        with self._mu:
            root = self._root
            if root is None:
                self._drop_locked(DROP_REASON_NO_TICK)
                return
            if parent is None:
                parent = root
            for tree in trees:
                try:
                    shard = (tree.get("attrs") or {}).get("shard", -1)
                    grafted = _renamespace(tree, f"sh{shard}")
                    grafted.pop("schema", None)
                    grafted.pop("trace_id", None)
                    grafted.pop("outcome", None)
                    parent.children.append(_DictSpan(grafted))
                except Exception:  # noqa: BLE001 — never bite
                    self._drop_locked(DROP_REASON_ENCODE_ERROR)

    # --- slow-tick flight recorder ---

    def note_overrun(self, engine_name: str = "") -> None:
        """PR-10 overrun hook: the tick that just ended ran longer than
        its poll interval — dump its full span tree for the operator."""
        self.dump_last(reason="overrun")

    def dump_last(self, reason: str = "manual") -> str | None:
        """Write the newest committed tick tree as a standalone JSON file
        under ``slow_dump_dir`` (bounded at MAX_SLOW_DUMPS per process).
        Returns the dump path, or None when there was nothing to dump or
        the write failed (counted, logged, never raised)."""
        with self._mu:
            tree = self.ring[-1] if self.ring else None
        if tree is None:
            return None
        directory = self.slow_dump_dir
        if not directory:
            import tempfile

            directory = os.path.join(tempfile.gettempdir(),
                                     "wva-slow-ticks")
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(
                directory,
                f"slow-tick-{tree.get('trace_id', 'unknown')}.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump({"reason": reason, **tree}, f, sort_keys=True)
        except OSError as e:
            self._drop(DROP_REASON_WRITE_ERROR)
            log.warning("slow-tick dump failed: %s", e)
            return None
        self.slow_dumps_total += 1
        self._slow_dump_paths.append(path)
        while len(self._slow_dump_paths) > MAX_SLOW_DUMPS:
            stale = self._slow_dump_paths.pop(0)
            try:
                os.unlink(stale)
            except OSError:
                pass
        if self.registry is not None:
            try:
                self.registry.observe_slow_tick_dump(reason)
            except Exception:  # noqa: BLE001
                pass
        log.warning("%s: span tree of tick %s dumped to %s (%.1f ms)",
                    reason, tree.get("trace_id"), path, tree.get("dur_ms"))
        return path

    # --- reading ---

    @property
    def trace_id(self) -> str:
        return self._trace_id

    def snapshot(self) -> list[dict]:
        """Committed tick trees currently in the ring (oldest first)."""
        with self._mu:
            return list(self.ring)

    def last_tree(self) -> dict | None:
        with self._mu:
            return self.ring[-1] if self.ring else None

    # --- internals ---

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        span.dur_ms = (time.perf_counter() - span._t0) * 1000.0
        if span._range is not None:
            self._close_range(span)
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()

    def _open_range(self, span: Span) -> None:
        """Enter the profiler range mirroring ``span``."""
        try:
            rng = self._mirror(RANGE_PREFIX + span.name)
            rng.__enter__()
        except Exception:  # noqa: BLE001 — observability must not bite
            return
        span._range = rng
        self._ranges.append(span)

    def _close_range(self, span: Span) -> None:
        """Exit ``span``'s range, and first every range opened after it
        and still open (a stage an exception left open), so the ranges
        close innermost first."""
        ranges = self._ranges
        while span._range is not None and ranges:
            inner = ranges.pop()
            rng, inner._range = inner._range, None
            try:
                rng.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass

    def _close_ranges(self) -> None:
        """Close every range still open, innermost first (the root's end,
        an abandoned or errored root)."""
        if self._ranges:
            self._close_range(self._ranges[0])

    def _drop(self, reason: str) -> None:
        with self._mu:
            self._drop_locked(reason)

    def _drop_locked(self, reason: str) -> None:
        self.dropped_total += 1
        if self.registry is not None:
            try:
                self.registry.observe_span_drop(reason)
            except Exception:  # noqa: BLE001
                pass

    def _spill(self, tree: dict) -> None:
        if self._spill_queue is None:
            return
        try:
            self._spill_queue.put_nowait(tree)
        except queue.Full:
            self._drop(DROP_REASON_WRITE_BACKLOG)
            log.warning("span spill backlog: writer cannot keep up with "
                        "%s; tree dropped from file (still in ring)",
                        self.spill_path)

    def _writer_loop(self) -> None:
        while True:
            tree = self._spill_queue.get()
            try:
                self._write_tree(tree)
            finally:
                self._spill_queue.task_done()

    def _write_tree(self, tree: dict) -> None:
        failed: Exception | None = None
        with self._spill_mu:
            try:
                if self._spill_file is None:
                    self._spill_file = open(  # noqa: SIM115 — long-lived
                        self.spill_path, "a", encoding="utf-8")
                self._spill_file.write(
                    json.dumps(tree, sort_keys=True,
                               separators=(",", ":")) + "\n")
                self._spill_file.flush()
            except Exception as e:  # noqa: BLE001 — a dead writer thread
                failed = e          # would silently end all future spills
        if failed is not None:
            self._drop(DROP_REASON_WRITE_ERROR)
            log.warning("span spill to %s failed: %s", self.spill_path,
                        failed)

    def flush(self) -> None:
        """Drain the spill queue and sync the file (tests, shutdown)."""
        if self._spill_queue is not None:
            self._spill_queue.join()
        with self._spill_mu:
            if self._spill_file is not None:
                try:
                    self._spill_file.flush()
                except OSError:
                    pass

    def close(self) -> None:
        self.flush()
        if self._otlp is not None:
            self._otlp.close()
        with self._spill_mu:
            if self._spill_file is not None:
                try:
                    self._spill_file.close()
                except OSError:
                    pass
                self._spill_file = None


class _DictSpan:
    """A pre-serialized (grafted) subtree masquerading as a Span for
    ``to_dict`` purposes — worker trees arrive already encoded."""

    __slots__ = ("_d",)

    def __init__(self, d: dict) -> None:
        self._d = d

    def to_dict(self) -> dict:
        return self._d


def _renamespace(tree: dict, prefix: str) -> dict:
    """Deep-copy a serialized subtree with every span id prefixed
    (``s3`` -> ``sh1:s3``) so grafted worker ids never collide with the
    fleet's own."""
    out = dict(tree)
    if "span_id" in out:
        out["span_id"] = f"{prefix}:{out['span_id']}"
    if tree.get("children"):
        out["children"] = [_renamespace(c, prefix)
                           for c in tree["children"]]
    return out
