"""DecisionTrace record schema: serialization for the flight recorder.

One JSONL record per engine cycle:

.. code-block:: json

    {"schema": 1, "cycle": 17, "ts": 1000123.0, "engine": "saturation-engine",
     "analyzer": "v1", "outcome": "success",
     "models":    [{"model_id": "...", "namespace": "...", "path": "v1",
                    "input": {"replica_metrics": [], "variant_states": [],
                              "config": {}, "scheduler_queue": null},
                    "analysis": {}, "targets": {},
                    "enforced_targets": {}, "scaled_to_zero": false}],
     "stages":    [{"stage": "enforcer", "...": "..."}],
     "decisions": [{"variant_name": "...", "decision_steps": []}],
     "post":      [{"stage": "reconcile", "...": "..."}]}

``models`` carries everything the replay engine needs to re-run the pipeline
(the analyzer INPUT for the stateless V1 path; the :class:`AnalyzerResult`
for the stateful V2/SLO analyzers, whose trend/EKF state cannot be
reconstructed from one cycle). ``stages`` carries the pipeline components'
own events (enforcer request counts, limiter inventory pools) recorded
during the cycle; ``post`` carries events attributed after the cycle ended
(reconciler status writes triggered by this cycle's decisions).

Encoding is plain :func:`dataclasses.asdict`; decoding is a small generic
type-hint-driven reconstructor, so interface dataclasses round-trip without
per-type glue. Floats round-trip exactly (JSON uses repr shortest-float).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Union, get_args, get_origin, get_type_hints

TRACE_SCHEMA_VERSION = 1

# Stage-event names used by the pipeline hooks.
STAGE_ENFORCER = "enforcer"
STAGE_OPTIMIZER = "optimizer"
STAGE_LIMITER = "limiter"
# Predictive capacity planner (wva_tpu_torch.forecast): per-model plans + the
# replica floors it applied, recorded between enforcement and the limiter.
# Replay re-applies the RECORDED floors (like the limiter replays from the
# recorded pool snapshot) — the planner's learned state is not
# reconstructable from one cycle.
STAGE_FORECAST = "forecast"
# Elastic capacity plane (wva_tpu_torch.capacity): per-tick ledger snapshot
# (ready/provisioning/preempted slices per variant, stocked-out tiers) plus
# the provisioning requests submitted/completed/expired this cycle.
# Recorded AFTER the limiter: capacity influences decisions only through
# the inventory pools the limiter stage already records, so replay needs
# no capacity-specific logic — the stage is pure observability.
STAGE_CAPACITY = "capacity"
STAGE_ACTUATION = "actuation"
STAGE_RECONCILE = "reconcile"
# Dirty-set incremental ticks: models whose input fingerprint was unchanged
# this cycle, so prepare->analyze was skipped and the prior cycle's decision
# re-emitted. Recorded so an incremental trace still explains every model's
# outcome (replay treats skipped models exactly like no-record models: the
# re-emitted decisions were already verified the cycle they were computed).
STAGE_FINGERPRINT_SKIP = "fingerprint_skip"
# Crash-restart resilience plane (wva_tpu_torch.resilience): recorded ONCE, on
# the first cycle after a boot that actually recovered something (warm-
# start seeds, checkpoint rehydration) or is still ramp-holding models.
# Pure observability: the boot ramp's do-no-harm clamps ride the health
# stage below (state "boot") and replay through the same shared
# health.apply path, so replay needs no boot-specific logic. A fresh
# fault-free boot records nothing — traces stay byte-identical with the
# plane off.
STAGE_BOOT = "boot"
# Sharded active-active engine (wva_tpu_torch.shard): recorded ONLY on cycles
# where shard topology changed — a shard joined/left/crashed and the
# consistent-hash ring moved model ownership (moves + the rebalance holds
# opened). Steady-state sharded cycles record nothing, so sharded traces
# stay byte-identical to the unsharded engine's (and to each other at any
# shard count). Pure observability: the rebalance ramp's do-no-harm clamps
# ride STAGE_HEALTH (state "rebalance") and replay through the shared
# health.apply path, so replay needs no shard-specific logic.
STAGE_SHARD = "shard"
# Input-health plane (wva_tpu_torch.health): per-model trust states this cycle
# plus the do-no-harm clamps the gate applied to final decisions. Recorded
# AFTER the limiter; replay re-applies the RECORDED clamps through the same
# shared code path (health.apply) — monitor state (ages, hysteresis
# streaks, last-known-good holds) is not reconstructable from one cycle.
# Only cycles where something was non-FRESH (or clamped) record the stage,
# so a fault-free world's trace carries no health events.
STAGE_HEALTH = "health"
# Multi-cluster federation plane (wva_tpu_torch.federation): the arbiter plan as
# THIS region saw it — region states (with capture ages and re-admission
# hysteresis) plus the spill directives applied to this region's final
# decisions. Recorded AFTER the health gate; replay re-applies the
# RECORDED directives through the shared federation.apply path — arbiter
# state (hysteresis books, other regions' captures) is not
# reconstructable from one cycle. Only cycles with a directive or a
# non-healthy region record the stage, so a healthy fleet's traces (and
# any single-cluster deployment's) stay byte-identical to the plane off.
STAGE_FEDERATION = "federation"

# Per-model pipeline paths.
PATH_V1 = "v1"
PATH_V2 = "v2"
PATH_SLO = "slo"


def encode(obj):
    """Dataclass / list / dict / scalar -> JSON-serializable structure."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: encode(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    return obj


# dataclass -> ((field name, resolved type hint), ...): resolving the hints
# evaluates every string annotation, most of a decode's time; a class's
# fields and hints never change, so each class resolves them once.
_FIELD_HINTS: dict[type, tuple[tuple[str, object], ...]] = {}


def _field_hints(cls) -> tuple[tuple[str, object], ...]:
    out = _FIELD_HINTS.get(cls)
    if out is None:
        hints = get_type_hints(cls)
        out = _FIELD_HINTS[cls] = tuple(
            (f.name, hints.get(f.name)) for f in dataclasses.fields(cls))
    return out


def decode(cls, data):
    """Reconstruct dataclass ``cls`` from :func:`encode` output. Unknown keys
    are ignored (forward compatibility with newer trace schemas)."""
    if data is None:
        return None
    kwargs = {}
    for name, hint in _field_hints(cls):
        if name in data:
            kwargs[name] = _decode_value(hint, data[name])
    return cls(**kwargs)


def _decode_value(tp, value):
    if value is None or tp is None:
        return value
    origin = get_origin(tp)
    # typing.Optional[X] and PEP 604 ``X | None`` have different origins.
    if origin is Union or origin is types.UnionType:
        for arg in get_args(tp):
            if arg is type(None):
                continue
            return _decode_value(arg, value)
        return value
    if origin in (list, tuple):
        args = get_args(tp)
        elem = args[0] if args else None
        return [_decode_value(elem, v) for v in value]
    if origin is dict:
        args = get_args(tp)
        elem = args[1] if len(args) > 1 else None
        return {k: _decode_value(elem, v) for k, v in value.items()}
    if dataclasses.is_dataclass(tp):
        return decode(tp, value)
    if tp is int and isinstance(value, float):
        return int(value)
    return value


def encode_scale_to_zero_config(cfg) -> dict:
    """``ScaleToZeroConfigData`` (model -> ModelScaleToZeroConfig)."""
    return {k: encode(v) for k, v in (cfg or {}).items()}


def decode_scale_to_zero_config(data) -> dict:
    from wva_tpu_torch.config.types import ModelScaleToZeroConfig

    return {k: decode(ModelScaleToZeroConfig, v)
            for k, v in (data or {}).items()}
