"""Grouped per-tick metrics collection (docs/design/metrics-plane.md).

Every model used to issue its own ~10 templated Prometheus queries per
engine tick, so a 48-model fleet fired ~480 HTTP queries per 5s tick —
exactly the per-job fan-out Autopilot (Rzadca et al., EuroSys 2020)
collapses into shared signal collection. This module makes the metrics
plane O(query templates) per tick instead of O(models x templates):

- :func:`build_grouped_query` rewrites a registered per-model template into
  ONE fleet-wide query by parsing it (the bundled PromQL-subset parser),
  dropping the ``model_name="..."``/``namespace="..."`` equality matchers
  (replaced by ``label!=""`` presence guards so series without the label
  never leak in), adding those labels to every enclosing aggregation's
  ``by`` clause, and serializing the AST back to PromQL.

- :class:`GroupedMetricsView` is a tick-scoped :class:`MetricsSource` view
  over a :class:`~wva_tpu_torch.collector.source.prometheus.PrometheusSource`:
  the first caller needing a template this tick executes the fleet-wide
  query once; its result is demultiplexed into per-(model, namespace)
  ``MetricResult`` slices that serve every other caller — and each slice is
  cached under the SAME per-model cache key the per-model path uses, so
  stale-serve-on-error semantics are preserved per model. Templates the
  rewriter cannot group, and templates a backend rejected, automatically
  fall back to the existing per-model refresh path.

Demux reproduces per-model evaluation byte-for-byte: group labels are
stripped from every output point, and for multi-branch queries (a
top-level ``a or b`` of aggregations, e.g. the scheduler flow-control
pair) ``or``-preference is applied per model over the stripped label
identity — a right-branch point survives only when no earlier branch
produced the same series for that model.
"""

from __future__ import annotations

import itertools
import logging
import threading
import urllib.error
from dataclasses import dataclass, field

from wva_tpu_torch.collector.source.promql import (
    Aggregation,
    BinaryOp,
    FuncCall,
    NumberLiteral,
    PromQLError,
    Selector,
    parse_query,
    to_promql,
)
from wva_tpu_torch.collector.source.query_template import (
    QUERY_TYPE_PROMQL,
    QueryTemplate,
    escape_promql_value,
)
from wva_tpu_torch.collector.source.source import (
    PARAM_MODEL_ID,
    PARAM_NAMESPACE,
    MetricResult,
    MetricsSource,
    RefreshSpec,
)
from wva_tpu_torch.utils.oncemap import OnceMap

log = logging.getLogger(__name__)

# Sentinel label values substituted for the per-model placeholders before
# parsing; the rewriter recognizes and removes the matchers carrying them.
MODEL_SENTINEL = "__wva_grouped_model__"
NS_SENTINEL = "__wva_grouped_namespace__"


class NotGroupableError(PromQLError):
    """The template's shape is outside the rewriter's rules; callers fall
    back to per-model collection."""


@dataclass(frozen=True)
class GroupedBranch:
    """Demux descriptor for one top-level aggregation branch: which output
    label carries the model id / namespace, and which labels to strip so
    the demuxed slice is byte-identical to the per-model result."""

    model_label: str
    ns_label: str  # "" when the template has no namespace dimension
    strip: tuple[str, ...]


@dataclass(frozen=True)
class GroupedQuery:
    promql: str
    branches: tuple[GroupedBranch, ...]
    has_namespace: bool
    # Versioned-fingerprint metadata (docs/design/informer.md
    # §versioned-fingerprints): the metric names the query selects. The
    # execution-reuse gate compares backend write/value versions across
    # exactly these names; the per-evaluation validity bounds (TrackMeta)
    # cover instant and range shapes alike.
    metric_names: tuple[str, ...] = ()


def _merge_pending(into: dict[str, str], kind: str, label: str) -> None:
    prev = into.get(kind)
    if prev is not None and prev != label:
        raise NotGroupableError(
            f"conflicting {kind} labels {prev!r} vs {label!r}")
    into[kind] = label


def _rewrite(node, scope_namespace: str = "",
             ) -> tuple[list[GroupedBranch], dict[str, str]]:
    """Transform ``node`` in place. Returns (branches absorbed by
    aggregations in this subtree, sentinel labels still pending an
    enclosing aggregation)."""
    if isinstance(node, NumberLiteral):
        # `vector(N)` parses into NumberLiteral, so serialization would
        # lose the vector() wrapper — and a bare scalar operand under `or`
        # is invalid PromQL on a real backend. Refuse; the template stays
        # per-model.
        raise NotGroupableError("scalar / vector() operand")
    if isinstance(node, Selector):
        pending: dict[str, str] = {}
        matchers: list[tuple[str, str, str]] = []
        for lbl, op, val in node.matchers:
            if val in (MODEL_SENTINEL, NS_SENTINEL):
                if op != "=":
                    raise NotGroupableError(
                        f"non-equality matcher {op!r} on grouped param")
                kind = "model" if val == MODEL_SENTINEL else "ns"
                _merge_pending(pending, kind, lbl)
                if kind == "ns" and scope_namespace:
                    # A namespace-scoped controller keeps its scope as an
                    # equality matcher — on a shared multi-tenant
                    # Prometheus the fleet-wide query must not aggregate
                    # every other tenant's series.
                    matchers.append((lbl, "=", scope_namespace))
                else:
                    # Presence guard: the dropped equality matcher also
                    # implied the label exists and is non-empty
                    # (Prometheus treats a missing label as ""), so series
                    # without it must stay out of the fleet-wide result.
                    matchers.append((lbl, "!=", ""))
            else:
                matchers.append((lbl, op, val))
        node.matchers = matchers
        return [], pending
    if isinstance(node, FuncCall):
        return _rewrite(node.arg, scope_namespace)
    if isinstance(node, Aggregation):
        branches, pending = _rewrite(node.arg, scope_namespace)
        if branches:
            # An aggregation ABOVE an already-grouped aggregation would
            # collapse the models back together; no registered template
            # nests aggregations, so bail to per-model collection.
            raise NotGroupableError("nested aggregation above a grouped one")
        if pending:
            model_label = pending.get("model")
            if model_label is None:
                raise NotGroupableError("namespace param without a model "
                                        "param under one aggregation")
            ns_label = pending.get("ns", "")
            group_labels = [model_label] + ([ns_label] if ns_label else [])
            for lbl in group_labels:
                if lbl not in node.by:
                    node.by.append(lbl)
            branches = [GroupedBranch(model_label, ns_label,
                                      tuple(group_labels))]
            pending = {}
        return branches, pending
    if isinstance(node, BinaryOp):
        left_branches, left_pending = _rewrite(node.left, scope_namespace)
        right_branches, right_pending = _rewrite(node.right, scope_namespace)
        merged = dict(left_pending)
        for kind, label in right_pending.items():
            _merge_pending(merged, kind, label)
        return left_branches + right_branches, merged
    raise NotGroupableError(f"unsupported node {node!r}")


def build_grouped_query(template: QueryTemplate,
                        extra_params: dict[str, str],
                        scope_namespace: str = "") -> GroupedQuery | None:
    """Rewrite one registered per-model template into its fleet-wide
    grouped form, or None when the template is outside the rewrite rules.
    ``extra_params`` are the template's non-model/namespace parameters
    (e.g. ``retentionPeriod``), substituted before parsing — the grouped
    query is memoized per distinct extra-param set. ``scope_namespace``
    (a namespace-scoped controller's watch namespace) is kept as an
    equality matcher instead of the fleet-wide presence guard."""
    if template.type != QUERY_TYPE_PROMQL:
        return None
    if PARAM_MODEL_ID not in template.params:
        return None
    text = template.template
    text = text.replace("{{." + PARAM_MODEL_ID + "}}", MODEL_SENTINEL)
    has_namespace = PARAM_NAMESPACE in template.params
    if has_namespace:
        text = text.replace("{{." + PARAM_NAMESPACE + "}}", NS_SENTINEL)
    for key, value in extra_params.items():
        text = text.replace("{{." + key + "}}", escape_promql_value(value))
    if "{{." in text:
        return None  # unsubstituted params left: not safely groupable
    try:
        ast = parse_query(text)
        branches, pending = _rewrite(ast, scope_namespace)
        if pending:
            raise NotGroupableError("model matcher outside any aggregation")
        if not branches:
            raise NotGroupableError("no model matcher found in template")
    except PromQLError as e:
        log.debug("template %s not groupable: %s", template.name, e)
        return None
    # Deduplicate identical branches (e.g. both sides of a division absorb
    # the same labels) while preserving or-preference order.
    seen: set[tuple[str, str]] = set()
    unique: list[GroupedBranch] = []
    for b in branches:
        if (b.model_label, b.ns_label) not in seen:
            seen.add((b.model_label, b.ns_label))
            unique.append(b)
    return GroupedQuery(promql=to_promql(ast), branches=tuple(unique),
                        has_namespace=has_namespace,
                        metric_names=_selector_names(ast) or ())


def _selector_names(node) -> tuple[str, ...] | None:
    """Metric names one transformed AST selects — the reuse-gate metadata
    on :class:`GroupedQuery`. None poisons the whole query (empty
    metric_names disables reuse): a node shape this walk does not
    understand must never UNDER-cover the version gate. Unreachable for
    today's groupable templates (_rewrite refuses every other shape)."""
    if isinstance(node, Selector):
        return (node.name,)
    if isinstance(node, (FuncCall, Aggregation)):
        return _selector_names(node.arg)
    if isinstance(node, BinaryOp):
        ln = _selector_names(node.left)
        rn = _selector_names(node.right)
        if ln is None or rn is None:
            return None
        return ln + tuple(n for n in rn if n not in ln)
    return None


def demux_points(gq: GroupedQuery, points, make_value):
    """Split one grouped result into per-(model, namespace) value lists.

    ``make_value(labels, point)`` builds the per-model output element from
    the stripped labels; point order within a slice follows branch order
    then backend order, matching per-model ``left or right`` evaluation.
    Returns ``{(model, namespace): [value, ...]}`` (namespace "" when the
    template has no namespace dimension)."""
    if len(gq.branches) == 1:
        # Single-branch fast path (most templates): no or-preference is
        # possible, so the per-point identity tuple and branch bookkeeping
        # are dead weight — demux straight into the output lists.
        branch = gq.branches[0]
        strip = branch.strip
        fast: dict[tuple[str, str], list] = {}
        for p in points:
            labels = p.labels
            model = labels.get(branch.model_label)
            if not model:
                continue
            ns = labels.get(branch.ns_label, "") if branch.ns_label else ""
            stripped = {k: v for k, v in labels.items() if k not in strip}
            fast.setdefault((model, ns), []).append(make_value(stripped, p))
        return fast
    assigned: dict[tuple[str, str], list[tuple[int, tuple, object]]] = {}
    for p in points:
        for bi, branch in enumerate(gq.branches):
            model = p.labels.get(branch.model_label)
            if not model:
                continue
            ns = p.labels.get(branch.ns_label, "") if branch.ns_label else ""
            stripped = {k: v for k, v in p.labels.items()
                        if k not in branch.strip}
            identity = tuple(sorted(stripped.items()))  # fp-lint: bounded
            # (one point's labels; multi-branch or-preference path only)
            assigned.setdefault((model, ns), []).append(
                (bi, identity, make_value(stripped, p)))
            break
    out: dict[tuple[str, str], list] = {}
    for key, entries in assigned.items():
        # Branch-major order (stable: backend order preserved within a
        # branch) — real Prometheus does not guarantee or-result ordering.
        entries.sort(key=lambda e: e[0])
        kept: list = []
        seen_earlier: set[tuple] = set()
        current: set[tuple] = set()
        last_branch = -1
        for bi, identity, value in entries:  # entries keep backend order
            if bi != last_branch:
                seen_earlier |= current
                current = set()
                last_branch = bi
            if identity in seen_earlier:
                continue  # or-preference: an earlier branch won this series
            current.add(identity)
            kept.append(value)
        out[key] = kept
    return out


def _canon_value(v):
    """NaN/Inf-canonicalized value for digests and fingerprints: NaN is
    not equal to itself, so a raw NaN in a fingerprint tuple makes the
    fingerprint never compare equal — the model would be pinned
    permanently dirty. Map non-finite floats to stable sentinels."""
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v == float("inf"):
            return "Inf"
        if v == float("-inf"):
            return "-Inf"
    return v


def _slice_digest(values) -> tuple:
    """Content digest of one demuxed per-model slice: order-insensitive
    (sorted (labels, value) pairs), timestamp-free, NaN-canonicalized.
    Bounded by the handful of series one model contributes to one
    template — never fleet-sized."""
    return tuple(sorted(  # fp-lint: bounded (one model's slice)
        (tuple(sorted(v.labels.items())), _canon_value(v.value))
        for v in values))


_EMPTY_DIGEST: tuple = ()

# One version book holds at most this many (spec, model) entries; past it
# the book resets wholesale (the counter keeps climbing, so every model
# re-dirties exactly once — the safe direction) instead of growing without
# bound on churning fleets.
_BOOK_MAX_ENTRIES = 65536


@dataclass
class _ExecMemo:
    """One memoized fleet-wide execution with two reuse tiers:

    - **strict** (collection-grade): unchanged backend write-version +
      before ``expiry_strict`` — the evaluation is byte-identical,
      timestamps included, so it may serve collectors.
    - **fingerprint-grade**: unchanged VALUE-version + ``uniform`` +
      before ``expiry_b`` — the result's values (hence slice digests and
      versions) are provably unchanged, but timestamps may have moved
      under same-value re-scrapes, so ONLY the timestamp-free
      fingerprint tier may consume it."""

    write_version: int
    value_version: int
    expiry_strict: float
    expiry_b: float
    uniform: bool
    slices: dict = field(default_factory=dict)  # (model, ns) -> [values]
    versions: dict = field(default_factory=dict)  # (model, ns) -> int


class SliceVersionBook:
    """Cross-tick slice-version store — the metrics half of the versioned
    fingerprint plane (``WVA_FP_DELTA``; docs/design/informer.md).

    Per (template, extras, scope) spec and per demuxed (model, namespace)
    slice it keeps the last content digest and a store-monotonic
    ``slice_version`` that bumps ONLY when the digest changes. The
    engine's dirty-set fingerprint then records the version (an int)
    instead of rebuilding and comparing the full sorted (labels, value)
    tuple per model per tick. Digests are stamped once per fleet-wide
    execution — inside the demux walk that already touches every slice —
    so a quiet tick's fingerprint work is O(templates) version lookups
    per model.

    The book also memoizes whole executions (``_ExecMemo``): backed by
    the ring-buffer TSDB's per-series write-versions and the
    evaluation's tracked validity bounds, an unchanged write-version
    proves byte-identical evaluation, so re-scrape-free quiet metrics
    skip the backend query entirely. Thread-safe; shared by engine ticks and the cache warmer."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._counter = itertools.count(1)
        # spec_key -> {(model, ns): (digest, version)}
        self._digests: dict[tuple, dict[tuple, tuple[tuple, int]]] = {}
        self._entries = 0
        self._exec_memo: dict[tuple, _ExecMemo] = {}
        # Introspection for tests/bench.
        self.reused_executions = 0

    def stamp(self, spec_key: tuple,
              digests: dict[tuple, tuple]) -> dict[tuple, int]:
        """Record this execution's slice digests; returns the slice
        versions (bumped only where the digest changed)."""
        with self._mu:
            book = self._digests.get(spec_key)
            if book is None:
                book = self._digests[spec_key] = {}
            out: dict[tuple, int] = {}
            for key, digest in digests.items():
                cur = book.get(key)
                if cur is not None and cur[0] == digest:
                    out[key] = cur[1]
                    continue
                version = next(self._counter)
                if cur is None:
                    self._entries += 1
                book[key] = (digest, version)
                out[key] = version
            if self._entries > _BOOK_MAX_ENTRIES:
                self._digests = {spec_key: book}
                self._entries = len(book)
                self._exec_memo.clear()
            return out

    def version_for(self, spec_key: tuple, slice_key: tuple,
                    digest: tuple) -> int:
        """Version of one slice given its current digest — the lazy path
        for models ABSENT from this tick's demux (their slice digest is
        the empty tuple, which must still version: present -> absent is a
        change)."""
        with self._mu:
            book = self._digests.get(spec_key)
            if book is None:
                book = self._digests[spec_key] = {}
            cur = book.get(slice_key)
            if cur is not None and cur[0] == digest:
                return cur[1]
            version = next(self._counter)
            if cur is None:
                self._entries += 1
            book[slice_key] = (digest, version)
            return version

    def note_execution(self, spec_key: tuple, memo: "_ExecMemo") -> None:
        with self._mu:
            self._exec_memo[spec_key] = memo

    def reusable(self, spec_key: tuple, write_version: int | None,
                 now: float) -> "_ExecMemo | None":
        """Strict (collection-grade) reuse: the backend write-version for
        the query's metric names is unchanged (no appends, no drops) and
        no included sample has left its window yet — the evaluation would
        be byte-identical, timestamps included."""
        if write_version is None:
            return None
        with self._mu:
            memo = self._exec_memo.get(spec_key)
            if (memo is None or memo.write_version != write_version
                    or now >= memo.expiry_strict):
                return None
            self.reused_executions += 1
            return memo

    def reusable_fp(self, spec_key: tuple, write_version: int | None,
                    value_version: int | None,
                    now: float) -> "_ExecMemo | None":
        """Fingerprint-grade reuse: strict reuse, OR value-version
        unchanged over a uniform evaluation before ``expiry_b`` — the
        result's VALUES provably did not move, so the memoized slice
        versions are current (timestamps may be stale, which the
        timestamp-free fingerprint never sees)."""
        memo = self.reusable(spec_key, write_version, now)
        if memo is not None:
            return memo
        if value_version is None:
            return None
        with self._mu:
            memo = self._exec_memo.get(spec_key)
            if (memo is None or not memo.uniform
                    or memo.value_version != value_version
                    or now >= memo.expiry_b):
                return None
            self.reused_executions += 1
            return memo

    def forget_execution(self, spec_key: tuple) -> None:
        with self._mu:
            self._exec_memo.pop(spec_key, None)


class GroupedMetricsView(MetricsSource):
    """Tick-scoped grouped-collection view over a PrometheusSource.

    Construct one per engine tick and hand it to every collector call site;
    it is thread-safe (the engine's analysis workers race into it), and the
    first worker to need a template runs the fleet-wide query while the
    rest wait on the per-template latch. Anything non-groupable delegates
    to the wrapped source unchanged, so disabling grouping is equivalent to
    bypassing the view entirely."""

    def __init__(self, source, scope_namespace: str = "",
                 versioned: bool = True, spans=None) -> None:
        self._source = source
        # Obs plane (WVA_SPANS): backend query + demux spans, recorded
        # under the engine's current tick tree. None = off (zero cost).
        self._spans = spans
        # Namespace-scoped controllers keep their watch namespace as an
        # equality matcher in the fleet-wide queries (shared-Prometheus
        # tenancy: never aggregate other tenants' series).
        self._scope_namespace = scope_namespace
        # Versioned fingerprint plane (WVA_FP_DELTA): stamp slice digests
        # into the source's SliceVersionBook during demux and allow
        # write-version-backed execution reuse. Off restores the
        # recomputed path byte-for-byte (the book is never touched).
        self._book = (getattr(source, "slice_book", None)
                      if versioned else None)
        # (name, extras, scope) -> demuxed {(model, ns): MetricResult} |
        # None when the grouped execution failed this tick (per-model
        # fallback).
        self._once = OnceMap()
        # slice_versions fast path: (name, extras) -> (versions | None,
        # spec_key, has_ns) resolved once per tick per template, so the
        # per-model fingerprint pays one dict hit instead of re-walking
        # template params / rewrite memo / execution latch per template.
        # Filled idempotently (engine thread only computes fingerprints,
        # but racing fills would agree anyway). _tpl_pre caches the
        # params-independent template preamble (param list, ns-ness,
        # extra-param names) per template name.
        self._vmap: dict[tuple, tuple] = {}
        self._tpl_pre: dict[str, tuple | None] = {}
        # Serving-tier plan memo (one view = one tick): the per-model
        # serve path used to re-walk template params and rebuild the
        # grouped query for every (model, template) pair — O(models *
        # templates) re-resolution per tick for plans that depend only on
        # the template and its non-model params. _plan_pre memoizes the
        # params-independent preamble (template, param list, ns-ness,
        # extra-param names; None = ungroupable template), _plan_gq the
        # resolved grouped query per (template, extras) — so a 1k-model
        # refresh pays one dict hit per serve instead of a full re-plan.
        self._plan_pre: dict[str, tuple | None] = {}
        self._plan_gq: dict[tuple, tuple] = {}
        # What this tick's view did (the engine puts them on its phase
        # spans): fleet-wide backend queries executed, executions served
        # from the version book's memo, and model slices demuxed.
        self._count_mu = threading.Lock()
        self._counts = {"queries": 0, "memo_hits": 0, "demuxed": 0}
        # Templates this tick's callers asked for (the fleet warm-up
        # excluded): what the sharded plane warms on its next tick.
        self._requested: set[str] = set()

    def counts(self) -> dict[str, int]:
        """A copy of this view's counts so far."""
        with self._count_mu:
            return dict(self._counts)

    def requested(self) -> frozenset[str]:
        """The templates this tick's collectors and fingerprints asked
        for, whether or not :meth:`warm_fleet_queries` ran them first."""
        return frozenset(self._requested)

    def _count(self, key: str, n: int = 1) -> None:
        with self._count_mu:
            self._counts[key] += n

    # --- MetricsSource ---

    def query_list(self):
        return self._source.query_list()

    def get(self, query_name: str, params: dict[str, str]):
        return self._source.get(query_name, params)

    def slice_age_seconds(self, queries, params: dict[str, str],
                          ) -> float | None:
        """Input-health age probe, delegated to the wrapped source's
        per-model cache — the grouped demux refreshes exactly those
        entries, so the probe sees grouped and per-model collection
        identically."""
        return self._source.slice_age_seconds(queries, params)

    def refresh(self, spec: RefreshSpec) -> dict[str, MetricResult]:
        names = list(spec.queries) or self._source.query_list().names()
        self._requested.update(names)
        results: dict[str, MetricResult] = {}
        passthrough: list[str] = []
        for name in names:
            served = self._serve_grouped(name, spec.params)
            if served is None:
                passthrough.append(name)
            else:
                results[name] = served
        if passthrough:
            results.update(self._source.refresh(
                RefreshSpec(queries=passthrough, params=dict(spec.params))))
        return results

    # --- grouped execution ---

    def _grouped_plan(self, name: str, params: dict[str, str]):
        """Shared precondition walk for grouped serving and fingerprint
        versioning: (template, model, ns, has_ns, gq, spec_key), or None
        to delegate to the per-model path. The exclusion rules are shared
        so the fingerprint's template coverage matches serving exactly.
        The params-independent legs (template resolution, grouped-query
        construction) are memoized per view — see ``_plan_pre``."""
        pre = self._plan_pre.get(name, False)
        if pre is False:
            template = self._source.query_list().get(name)
            if (template is None or template.type != QUERY_TYPE_PROMQL
                    or PARAM_MODEL_ID not in template.params):
                pre = None
            else:
                tp = template.params
                pre = (template, tuple(tp), PARAM_NAMESPACE in tp,
                       tuple(k for k in tp
                             if k not in (PARAM_MODEL_ID, PARAM_NAMESPACE)))
            self._plan_pre[name] = pre
        if pre is None:
            return None
        template, tparams, has_ns, extra_names = pre
        model = params.get(PARAM_MODEL_ID)
        if not model:
            return None
        for p in tparams:
            if p not in params:
                return None  # let the per-model path raise its usual error
        ns = params.get(PARAM_NAMESPACE, "") if has_ns else ""
        # Template-order extras dict (what grouped_query_for always saw);
        # the sorted tuple is both the memo key and the spec key.
        extras = {k: params[k] for k in extra_names}
        ekey = tuple(sorted(extras.items()))  # fp-lint: bounded
        hit = self._plan_gq.get((name, ekey))
        if hit is None:
            gq = self._source.grouped_query_for(name, extras,
                                                self._scope_namespace)
            key = (name, ekey, self._scope_namespace)
            hit = (gq, key)
            self._plan_gq[(name, ekey)] = hit
        gq, key = hit
        if gq is None:
            return None
        return template, model, ns, has_ns, gq, key

    def _serve_grouped(self, name: str,
                       params: dict[str, str]) -> MetricResult | None:
        """The per-model slice for ``params`` from this tick's fleet-wide
        result, or None to delegate to the per-model path."""
        plan = self._grouped_plan(name, params)
        if plan is None:
            return None
        _, model, ns, has_ns, gq, key = plan
        demuxed = self._demuxed(key, name, gq, params, has_ns)
        if demuxed is None:
            return None  # grouped execution failed: per-model fallback
        result = demuxed.get((model, ns))
        if result is None:
            # Same outcome the per-model query would produce: an empty
            # (but successful) result — cached under the per-model key so
            # a later backend outage stale-serves "no data", not ancient
            # data.
            result = MetricResult(query_name=name, values=[],
                                  collected_at=demuxed["__collected_at__"])
            self._source.store_demuxed_result(name, dict(params), result)
        return result

    def warm_fleet_queries(self, params: dict[str, str],
                           names=None) -> None:
        """Execute every groupable template's fleet-wide query into this
        tick view's memo (idempotent — later callers hit the OnceMap).
        The sharded fleet tick warms its SHARED view here before driving
        the shard workers, so the backend's share of the tick (the
        O(series) fleet-wide evaluation a real Prometheus computes
        server-side) is paid once at the fleet level instead of inside
        whichever worker happens to touch a template first. Serving and
        digest stamping are exactly what the first organic toucher would
        have done — decisions and fingerprints are byte-identical.
        ``names`` limits the warm-up to those templates (the previous
        tick's :meth:`requested`), so templates no caller reads — the
        tuner's per-pod rates with the tuner off — are not run at all, as
        the unsharded tick never runs them; a template first asked for
        later is run by its first caller."""
        for name in self._source.query_list().names():
            if names is not None and name not in names:
                continue
            try:
                self._serve_grouped(name, params)
            except Exception:  # noqa: BLE001 — warm failures re-surface
                # (or fall back per-model) on the organic serve path.
                log.debug("fleet warm failed for %s", name, exc_info=True)

    def slice_fingerprint(self, queries, params: dict[str, str]) -> tuple:
        """Digest of this tick's demuxed slices for ``params`` across
        ``queries`` — the metrics component of the engine's dirty-set
        fingerprint (docs/design/informer.md). Serving goes through the
        same memoized fleet-wide execution the collectors use, so
        fingerprinting costs zero extra backend queries on a tick that
        analyzes anything. Hashes (labels, value) only — never collection
        timestamps, which move every tick even when the data does not.
        Ungroupable / failed / param-incomplete templates are excluded
        (stably, so their absence cannot churn the digest). This is the
        RECOMPUTED path (``WVA_FP_DELTA=off``); the shipped path is
        :meth:`slice_versions`."""
        parts: list[tuple] = []
        self._requested.update(queries)
        for name in queries:
            template = self._source.query_list().get(name)
            if template is None:
                continue
            if any(p not in params for p in template.params):
                continue
            sliced = self._serve_grouped(name, params)
            if sliced is None:
                continue
            # _canon_value: a raw NaN here would make the fingerprint
            # never equal itself (NaN != NaN inside the tuple compare),
            # silently pinning the model permanently dirty.
            values = tuple(sorted(  # fp-lint: bounded (one model's slice)
                (tuple(sorted(v.labels.items())), _canon_value(v.value))
                for v in sliced.values))
            parts.append((name, values))
        return tuple(parts)

    def slice_versions(self, queries, params: dict[str, str]) -> tuple:
        """Delta-maintained twin of :meth:`slice_fingerprint`
        (``WVA_FP_DELTA``, default on): O(templates) version lookups per
        model instead of rebuilding sorted (labels, value) tuples. The
        versions come from the source's :class:`SliceVersionBook`,
        stamped once per fleet-wide execution inside :meth:`_execute`'s
        demux walk; a version moves iff the slice's content digest moved,
        so equality dynamics match the recomputed fingerprint exactly
        (asserted by the equivalence mode and the property test).
        Template exclusion rules are shared with serving via
        :meth:`_grouped_plan`, so coverage cannot diverge."""
        parts: list[tuple] = []
        model = params.get(PARAM_MODEL_ID)
        if not model:
            return ()
        self._requested.update(queries)
        for name in queries:
            pre = self._tpl_pre.get(name, False)
            if pre is False:
                template = self._source.query_list().get(name)
                if template is None:
                    pre = None
                else:
                    tp = template.params
                    pre = (tuple(tp), PARAM_NAMESPACE in tp,
                           tuple(k for k in tp
                                 if k not in (PARAM_MODEL_ID,
                                              PARAM_NAMESPACE)))
                self._tpl_pre[name] = pre
            if pre is None:
                continue
            tparams, has_ns, extra_names = pre
            if any(p not in params for p in tparams):
                continue
            extras_key = (() if not extra_names else
                          tuple(sorted(  # fp-lint: bounded (tpl params)
                              (k, params[k]) for k in extra_names)))
            ns = params.get(PARAM_NAMESPACE, "") if has_ns else ""
            mkey = (name, extras_key)
            hit = self._vmap.get(mkey)
            if hit is None:
                # First model asking for this template this tick: resolve
                # the grouped plan and run (or version-reuse) the ONE
                # fleet-wide execution; every later model pays a dict hit.
                plan = self._grouped_plan(name, params)
                if plan is None:
                    self._vmap[mkey] = hit = ("excluded", None, None)
                else:
                    _, _, _, _, gq, key = plan
                    vmap = self._fp_versions(key, name, gq, params, has_ns)
                    if vmap is None:
                        # Failed execution: excluded this tick, like the
                        # legacy path (not memoized as a terminal state —
                        # the OnceMap already pins the failure per tick).
                        hit = ("excluded", None, None)
                    else:
                        hit = ("ok", vmap, key)
                        self._vmap[mkey] = hit
            state, versions, key = hit
            if state == "excluded":
                continue
            version = versions.get((model, ns))
            if version is None:
                # Model absent from this tick's demux: its slice is empty,
                # which must still version (present -> absent is a change).
                # Written back into the (cross-tick, book-memoized)
                # versions map so later models — and later quiet ticks
                # reusing the same memo — pay a dict hit, not a book
                # lock round-trip.
                version = self._book.version_for(key, (model, ns),
                                                 _EMPTY_DIGEST)
                versions[(model, ns)] = version
            parts.append((name, version))
        return tuple(parts)

    def slice_versions_bulk(self, queries,
                            pairs: list[tuple[str, str]],
                            ) -> dict[tuple[str, str], tuple]:
        """Template-major bulk form of :meth:`slice_versions` for the
        engine's partition pass: resolves each template ONCE, then walks
        the fleet with one dict lookup per (model, namespace) — the
        per-model re-walk of template params/plan/latch state is hoisted
        out of the O(models) loop entirely. Exclusion rules and version
        values are identical to per-model slice_versions with
        ``{model, namespace}`` params (the fingerprint queries' only
        shape)."""
        out: dict[tuple[str, str], list] = {p: [] for p in pairs}
        if not pairs:
            return {}
        self._requested.update(queries)
        for name in queries:
            first_model, first_ns = pairs[0]
            params = {PARAM_MODEL_ID: first_model,
                      PARAM_NAMESPACE: first_ns}
            plan = self._grouped_plan(name, params)
            if plan is None:
                continue
            template, _, _, has_ns, gq, key = plan
            if any(p not in params for p in template.params):
                continue
            versions = self._fp_versions(key, name, gq, params, has_ns)
            if versions is None:
                continue
            book = self._book
            for pair in pairs:
                model, ns = pair
                slice_key = (model, ns if has_ns else "")
                version = versions.get(slice_key)
                if version is None:
                    # Absent slice = empty digest; written back so later
                    # models and later memo-reusing ticks pay a dict hit.
                    version = book.version_for(key, slice_key,
                                               _EMPTY_DIGEST)
                    versions[slice_key] = version
                out[pair].append((name, version))
        return {p: tuple(parts) for p, parts in out.items()}

    def _demuxed(self, key, name: str, gq: GroupedQuery,
                 params: dict[str, str], has_ns: bool):
        """Memoized fleet-wide execution + demux for one (template,
        extras, scope) this tick. Concurrent callers for the same key wait
        on a latch instead of issuing duplicate backend queries."""
        return self._once.get_or_compute(
            key, lambda: self._execute(name, gq, params, has_ns, key=key))

    def _fp_versions(self, key, name: str, gq: GroupedQuery,
                     params: dict[str, str], has_ns: bool):
        """Fingerprint-tier access to this tick's slice versions: serves
        from the fingerprint-grade execution memo (value-version gate)
        when possible — the memoized versions are then current even
        though timestamps may not be, which the timestamp-free
        fingerprint never reads. Falls through to the full (collection-
        grade) execution otherwise. Returns the versions map or None
        when the execution failed / the book is off."""
        fp_key = ("fp",) + key

        def compute():
            book = self._book
            if book is not None and gq.metric_names:
                write_v = self._source.backend_write_version(
                    gq.metric_names)
                value_v = self._source.backend_value_version(
                    gq.metric_names)
                memo = book.reusable_fp(key, write_v, value_v,
                                        self._source.clock.now())
                if memo is not None:
                    self._count("memo_hits")
                    return memo.versions
            demuxed = self._demuxed(key, name, gq, params, has_ns)
            if demuxed is None:
                return None
            return demuxed.get("__versions__")

        return self._once.get_or_compute(fp_key, compute)

    def _execute(self, name: str, gq: GroupedQuery, params: dict[str, str],
                 has_ns: bool, key: tuple | None = None,
                 organic: bool = True):
        collected_at = self._source.clock.now()
        book = self._book if key is not None else None
        write_version = value_version = None
        if book is not None and gq.metric_names:
            # Captured BEFORE evaluation: a write racing the query makes
            # the memo conservatively stale (re-executes next tick), never
            # silently fresh.
            write_version = self._source.backend_write_version(
                gq.metric_names)
            value_version = self._source.backend_value_version(
                gq.metric_names)
            memo = book.reusable(key, write_version, collected_at)
            if memo is not None:
                self._count("memo_hits")
                # Provably byte-identical evaluation (no writes/drops to
                # the query's metrics, no sample left its window): skip
                # the backend query, re-emit the memoized slices under a
                # fresh collected_at.
                return self._emit_demuxed(name, params, has_ns,
                                          memo.slices, collected_at,
                                          versions=memo.versions, key=key,
                                          organic=organic)
        qspan = (self._spans.begin_span("backend_query", template=name)
                 if self._spans is not None else None)
        self._count("queries")
        try:
            points, meta = self._source.execute_grouped_tracked(
                name, gq.promql)
        except Exception as e:  # noqa: BLE001 — grouped failure falls back
            if self._spans is not None:
                self._spans.end_span(qspan, outcome="fallback")
            log.debug("grouped query %s failed (%s); falling back to "
                      "per-model collection", name, e)
            if book is not None:
                book.forget_execution(key)
            # Only DETERMINISTIC rejections (the backend executed or
            # parsed the query and said no) pin the template per-model for
            # the retry window. A transient transport blip must fall back
            # for this tick only — pinning on a timeout would amplify load
            # ~models-fold against a recovering backend for 10 minutes.
            if _is_deterministic_rejection(e):
                self._source.note_grouped_rejection(name, e)
            return None
        slices = demux_points(gq, points, self._source.make_metric_value)
        versions = None
        if book is not None:
            # Stamp slice digests in the same pass that already walked
            # every slice; a version bumps only when its digest moved.
            versions = book.stamp(key, {
                slice_key: _slice_digest(values)
                for slice_key, values in slices.items()})
            if (write_version is not None and value_version is not None
                    and meta is not None):
                book.note_execution(key, _ExecMemo(
                    write_version=write_version,
                    value_version=value_version,
                    expiry_strict=meta.expiry_strict,
                    expiry_b=meta.expiry_b,
                    uniform=meta.uniform,
                    slices=dict(slices), versions=versions))
        if self._spans is not None:
            # One span covers query + demux + digest stamping — the
            # collector's whole backend round-trip for this template.
            self._spans.end_span(qspan, slices=len(slices))
        return self._emit_demuxed(name, params, has_ns, slices,
                                  collected_at, versions=versions, key=key,
                                  organic=organic)

    def _emit_demuxed(self, name: str, params: dict[str, str], has_ns: bool,
                      slices: dict, collected_at: float, versions=None,
                      key: tuple | None = None, organic: bool = True):
        """Build the tick's demuxed map from per-slice value lists and
        refresh the per-model stale-serve cache entries."""
        demuxed: dict = {"__collected_at__": collected_at}
        if versions is not None:
            demuxed["__versions__"] = versions
        self._count("demuxed", len(slices))
        for (model, ns), values in slices.items():
            result = MetricResult(query_name=name, values=values,
                                  collected_at=collected_at)
            demuxed[(model, ns)] = result
            # Per-model stale-serve parity: each demuxed slice lands in the
            # source's cache under the SAME key the per-model path uses, so
            # an outage next tick serves the per-model stale entry.
            slice_params = dict(params)
            slice_params[PARAM_MODEL_ID] = model
            if has_ns:
                slice_params[PARAM_NAMESPACE] = ns
            self._source.store_demuxed_result(name, slice_params, result)
        if organic and key is not None:
            # Remember the grouped spec ONCE per execution (not once per
            # served model) so the background cache warmer re-executes the
            # fleet-wide query between ticks. Warmer executions come
            # through warm_grouped_spec with organic=False and never
            # renew. The view's versioned flag rides along so a warm pass
            # replays it — with WVA_FP_DELTA off the warmer must behave
            # pre-change too (no stamping, no reuse).
            self._source.remember_grouped_spec(
                name, dict(key[1]), self._scope_namespace,
                versioned=self._book is not None)
        return demuxed


def _is_deterministic_rejection(e: Exception) -> bool:
    """Did the backend actually REJECT the grouped form (4xx / query
    error), as opposed to failing transiently (timeout, connection
    reset)?"""
    if isinstance(e, urllib.error.HTTPError):
        return 400 <= e.code < 500
    if isinstance(e, PromQLError):
        return True  # in-memory engine refused the query shape
    # HTTPPromAPI surfaces a 200-with-error payload ("status": "error",
    # e.g. errorType bad_data) as this RuntimeError: the backend parsed
    # and refused the query.
    return isinstance(e, RuntimeError) and "prometheus query failed" in str(e)


def warm_grouped_spec(source, name: str, extras: dict[str, str],
                      scope_namespace: str = "",
                      versioned: bool = True) -> bool:
    """Re-execute one remembered fleet-wide query and refresh every demuxed
    per-model cache slice — the cache warmer's grouped path (with grouped
    collection on, per-model specs never reach the warmer, so without this
    the stale-serve cache would decay to tick cadence). ``versioned``
    replays the engine view's WVA_FP_DELTA state: with the lever off the
    warm pass must not touch the version book either. Returns False when
    the template is no longer groupable or the backend failed."""
    template = source.query_list().get(name)
    if template is None:
        return False
    gq = source.grouped_query_for(name, extras, scope_namespace)
    if gq is None:
        return False
    view = GroupedMetricsView(source, scope_namespace=scope_namespace,
                              versioned=versioned)
    has_ns = PARAM_NAMESPACE in template.params
    key = (name, tuple(sorted(extras.items())),  # fp-lint: bounded
           scope_namespace)                      # (template params)
    return view._execute(name, gq, dict(extras), has_ns, key=key,
                         organic=False) is not None
