"""The capacity planner: forecast-at-(now + measured lead time) -> proactive
replica floor + scale-from-zero pre-wake.

Per engine tick (on the engine thread, in sorted model order — decisions
stay byte-deterministic at any analysis-pool width):

1. every model's observed demand lands in the history store (the fast-path
   monitor adds between-tick samples through the same entry point);
2. every model's variant states feed the lead-time estimator;
3. matured backtest entries (forecasts whose target time has arrived) are
   scored against realized demand — a rolling symmetric-MAPE per
   (model, forecaster) is the selection signal (Autopilot-style: choose by
   replayed error, not by faith);
4. all models' forecasters are fitted in ONE padded jitted JAX call;
5. per model, the best TRUSTED forecaster's forecast at (now + lead time)
   becomes a proactive replica floor on the variant the decisions favor.

Guardrails (the planner must never be worse than reactive):

- **No trust, no floor.** A forecaster must survive ``min_trust_evals``
  matured backtests with rolling error <= ``demote_error_threshold``
  before its forecast moves a single replica.
- **Auto-demotion.** When the BEST forecaster's rolling error exceeds the
  threshold, the model demotes to reactive (floor withdrawn) until the
  error decays back under it — a forecast miss decays the floor by
  construction, since the miss raises the rolling error that gates it.
- **Growth only.** Floors only ever RAISE a decision's target; scale-down
  stays reactive (mirrors ``DemandTrend``'s max(slope, 0)).
- **Limiter last.** Floors apply before the slice limiter, so whole-slice
  inventory caps always bind (a floor can never allocate chips that do not
  exist).
"""

from __future__ import annotations

import logging
import math
import threading
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass, field

from wva_tpu_torch.forecast import forecasters as fc
from wva_tpu_torch.forecast.history import DemandHistoryStore
from wva_tpu_torch.forecast.leadtime import LeadTimeEstimator

log = logging.getLogger(__name__)

# Bound on remembered not-yet-matured forecasts per model. Entries are
# appended once per engine tick and popped unconditionally once their due
# time passes, so the steady-state depth is (lead time / tick interval).
# The bound must exceed that for the LONGEST credible lead or forecasts
# would be evicted before maturation and trust could never be earned: at a
# 15s tick, 1024 entries cover a 4.2h lead — beyond the lead-time
# estimator's own episode timeout (1h), so the cap is a runaway backstop,
# never a scoring ceiling. Memory is trivial (4 floats per entry).
MAX_PENDING = 1024
# A matured forecast scores only when a realized-demand sample exists
# within this many fine-grid steps of the target time.
REALIZED_TOLERANCE_STEPS = 4.0


@dataclass
class ForecastPlan:
    """One model's planning record for a tick (flight-recorded under the
    ``forecast`` stage; round-trips through the blackbox schema)."""

    model_id: str = ""
    namespace: str = ""
    demand: float = 0.0
    lead_time_seconds: float = 0.0
    lead_time_measured: bool = False
    forecaster: str = ""
    forecast_demand: float = 0.0
    forecasts: dict[str, float] = field(default_factory=dict)
    errors: dict[str, float] = field(default_factory=dict)
    evals: dict[str, int] = field(default_factory=dict)
    trusted: bool = False
    demoted: bool = False
    floor_replicas: int = 0
    variant_name: str = ""
    reason: str = ""


@dataclass
class _Pending:
    due: float
    horizon: float
    forecasts: dict[str, float]


@dataclass
class PreparedTick:
    """The planning pass split at the device boundary (the fused decision
    plane, docs/design/fused-plane.md): everything :meth:`plan` does
    BEFORE the forecaster fit — demand/variant observation, idle
    eviction, grid resampling, backtest scoring, trust selection — done
    up front so the fit itself can ride the tick's ONE fused dispatch.
    The engine fills ``fits``/``chosen`` from the fused result and hands
    the whole object back to :meth:`plan`, which then runs the same
    per-model planning loop the staged path runs.

    ``trust_idx``/``trusted`` are the model axis's mask columns: the
    selected forecaster's registry index (UNTRUSTED = no forecaster past
    the gate; the program gathers the linear floor) and whether its
    rolling error clears the demotion threshold.
    """

    now: float = 0.0
    keys: list[str] = field(default_factory=list)
    grids: list = field(default_factory=list)
    horizons: list[tuple[float, bool]] = field(default_factory=list)
    trust_idx: list[int] = field(default_factory=list)
    trusted: list[bool] = field(default_factory=list)
    fits: list[dict[str, float]] | None = None
    chosen: list[float] | None = None
    # The global-routed mask column as the engine's no-floor partition:
    # keys of models the fleet-wide solver owns (a per-model floor would
    # fight its deliberate starvation/migration sequencing).
    global_no_floor: frozenset = frozenset()


class CapacityPlanner:
    """Thread-safe predictive planner; one instance per engine."""

    def __init__(self, seasonal_period_seconds: float = 86400.0,
                 grid_step_seconds: float = 15.0,
                 default_lead_time_seconds: float = 150.0,
                 lead_time_quantile: float = 0.9,
                 target_utilization: float = 0.85,
                 demote_error_threshold: float = 0.35,
                 min_trust_evals: int = 3,
                 growth_min_ratio: float = 1.05,
                 error_ewma_alpha: float = 0.3,
                 prewake_enabled: bool = True,
                 prewake_min_demand: float = 1.0,
                 prewake_check_interval: float = 30.0,
                 batched: bool = True, device=None) -> None:
        self.period = max(seasonal_period_seconds, 1.0)
        self.grid_step = max(grid_step_seconds, 1.0)
        # Long grid: SEASON_STEPS cells per period -> N_GRID/SEASON_STEPS
        # (2.5) periods of context.
        self.long_step = self.period / fc.SEASON_STEPS
        self.target_utilization = min(max(target_utilization, 0.05), 1.0)
        self.demote_error_threshold = demote_error_threshold
        self.min_trust_evals = max(min_trust_evals, 1)
        self.growth_min_ratio = growth_min_ratio
        self.error_ewma_alpha = error_ewma_alpha
        self.prewake_enabled = prewake_enabled
        self.prewake_min_demand = prewake_min_demand
        self.prewake_check_interval = prewake_check_interval
        self.batched = batched
        # Where the fits run: None is the CUDA card, "cpu" the plain
        # version.
        self.device = device
        self.history = DemandHistoryStore(
            window_seconds=self.long_step * fc.N_GRID,
            fine_window_seconds=self.grid_step * fc.N_GRID,
            long_gap_seconds=self.long_step / 2.0)
        self.leadtime = LeadTimeEstimator(
            quantile=lead_time_quantile,
            default_seconds=default_lead_time_seconds)
        self._mu = threading.Lock()
        # key -> pending (not yet matured) forecast evaluations.
        self._pending: dict[str, deque[_Pending]] = {}
        # (key, forecaster) -> (ewma error, eval count).
        self._errors: dict[tuple[str, str], tuple[float, int]] = {}
        self._last_plan: dict[str, ForecastPlan] = {}
        self._last_prewake_check: dict[str, float] = {}
        # key -> EWMA of realized demand: the error denominator is floored
        # at a fraction of the model's own demand scale, so a forecast off
        # by 0.01 req/s against a realized 0 during a quiet phase does not
        # score as a 200% miss and demote a good seasonal forecaster
        # (symmetric MAPE is unstable at zero; units vary per analyzer, so
        # the floor must be scale-relative, never a constant).
        self._demand_scale: dict[str, float] = {}
        # key -> the accelerator serving most of the model's replicas, so
        # lead-time estimates for a model with no samples of its own can
        # fall back to the fleet's measured latencies for that accelerator.
        self._accel_by_key: dict[str, str] = {}

    # -- feeds --

    @staticmethod
    def key_for(namespace: str, model_id: str) -> str:
        return f"{namespace}|{model_id}"

    def observe_demand(self, namespace: str, model_id: str, now: float,
                       demand: float) -> None:
        """Record one demand sample (engine tick or fast-path feed)."""
        self.history.observe(self.key_for(namespace, model_id), now,
                             max(demand, 0.0))

    def observe_variants(self, namespace: str, model_id: str,
                         variant_states, now: float) -> None:
        key = self.key_for(namespace, model_id)
        best = None
        for vs in variant_states:
            self.leadtime.observe(key, vs.variant_name, vs.accelerator_name,
                                  vs.desired_replicas, vs.ready_replicas, now)
            if vs.accelerator_name and (
                    best is None or vs.ready_replicas > best[0]):
                best = (vs.ready_replicas, vs.accelerator_name)
        if best is not None:
            with self._mu:
                self._accel_by_key[key] = best[1]

    def _estimate_lead(self, key: str) -> tuple[float, bool]:
        """Lead time for a model: own samples, else the fleet's measured
        latencies for the accelerator it runs on, else the default."""
        with self._mu:
            accel = self._accel_by_key.get(key, "")
        return self.leadtime.estimate(key, accel)

    # -- planning --

    def prepare_tick(self, entries, now: float) -> PreparedTick:
        """Everything :meth:`plan` does before the forecaster fit, for
        the fused decision plane. ``entries`` are ``(namespace,
        model_id, demand, variant_states)`` tuples for the models that
        will produce scaling requests this tick; they are processed in
        the exact (namespace, model_id) order ``plan`` sorts requests
        into, so the planner's learned state (history rings, lead-time
        samples — including the shared per-accelerator fallback rings —
        idle eviction, backtest scores) evolves byte-identically to the
        staged pass.

        Backtest scoring and trust selection run here too: scoring
        depends only on history + pending entries (all pre-fit state),
        nothing matures between this call and the per-model planning
        loop within one tick, and ``_plan_model``'s own scoring call is
        then a no-op — which is what makes the trust-index column the
        device gather reads agree with the host's trust rule.

        Caveat: if a model observed here never reaches :meth:`plan`
        (a downstream per-model failure), its demand sample and scores
        stay — one extra history point on an abnormal path."""
        ordered = sorted(entries, key=lambda e: (e[0], e[1]))
        prep = PreparedTick(now=now)
        for ns, model, demand, variant_states in ordered:
            key = self.key_for(ns, model)
            self.observe_demand(ns, model, now, demand)
            self.observe_variants(ns, model, variant_states, now)
            prep.keys.append(key)
        self._evict_dead_keys(now)
        for key in prep.keys:
            lead, measured = self._estimate_lead(key)
            prep.grids.append(self._grids_for(key, now, lead))
            prep.horizons.append((lead, measured))
            with self._mu:
                self._score_matured(key, now)
                best, best_err, _ = self._best_trusted_locked(key)
            if best is None:
                prep.trust_idx.append(-1)
                prep.trusted.append(False)
            else:
                prep.trust_idx.append(fc.FORECASTERS.index(best))
                prep.trusted.append(
                    best_err <= self.demote_error_threshold)
        return prep

    def plan(self, requests, now: float,
             no_floor_keys: frozenset[str] = frozenset(),
             prepared: PreparedTick | None = None,
             ) -> tuple[list[ForecastPlan], list[dict]]:
        """One planning pass over this tick's models. ``requests`` are the
        engine's :class:`ModelScalingRequest`s (result + variant states).
        Returns (plans, floors); apply floors with
        :func:`~wva_tpu_torch.forecast.apply.apply_forecast_floors`.

        ``no_floor_keys`` — models whose placement another authority owns
        (the fleet-wide global optimizer deliberately starves low-priority
        models on constrained pools; a per-model floor would fight that
        assignment). They still get the full learning pass (history,
        lead times, backtest scoring) — only the floor is withheld.

        ``prepared`` — a :class:`PreparedTick` from :meth:`prepare_tick`.
        The learning pass (observation, eviction, scoring) already ran,
        so it must NOT run again: requests are matched to prepared rows
        by key (a downstream per-model failure may have dropped some —
        the surviving subset reuses its rows; row-independent fits make
        the subset bitwise what a fresh fit would produce). When the
        fused dispatch failed, ``prepared.fits`` is None and the fit
        runs here as its own (staged) dispatch over the prepared grids —
        the degradation path stays byte-identical to WVA_FUSED=off.
        Only a request whose key was never prepared (should not happen)
        forces the full staged pass, which re-observes — a benign
        duplicate on an already-abnormal path."""
        reqs = sorted(requests, key=lambda r: (r.namespace, r.model_id))
        live_reqs = [r for r in reqs if r.result is not None]
        if prepared is not None:
            req_keys = [self.key_for(r.namespace, r.model_id)
                        for r in live_reqs]
            if not set(req_keys) <= set(prepared.keys):
                prepared = None
        chosen: list[float] | None = None
        if prepared is not None:
            rows = {k: i for i, k in enumerate(prepared.keys)}
            idx = [rows[k] for k in req_keys]
            keyed = list(zip(req_keys, live_reqs))
            grids = [prepared.grids[i] for i in idx]
            horizons = [prepared.horizons[i] for i in idx]
            if prepared.fits is not None:
                fits = [prepared.fits[i] for i in idx]
                chosen = ([prepared.chosen[i] for i in idx]
                          if prepared.chosen is not None else None)
            else:
                fits = (fc.fit_batch(grids, self.device) if self.batched
                        else fc.fit_serial(grids, self.device))
        else:
            keyed = []
            for req in reqs:
                if req.result is None:
                    continue
                key = self.key_for(req.namespace, req.model_id)
                self.observe_demand(req.namespace, req.model_id, now,
                                    req.result.total_demand)
                self.observe_variants(req.namespace, req.model_id,
                                      req.variant_states, now)
                keyed.append((key, req))
            self._evict_dead_keys(now)

            grids, horizons = [], []
            for key, req in keyed:
                lead, measured = self._estimate_lead(key)
                grids.append(self._grids_for(key, now, lead))
                horizons.append((lead, measured))
            fits = (fc.fit_batch([g for g in grids], self.device)
                    if self.batched
                    else fc.fit_serial([g for g in grids], self.device))

        plans: list[ForecastPlan] = []
        floors: list[dict] = []
        for i, ((key, req), grid, fit, (lead, measured)) in enumerate(zip(
                keyed, grids, fits, horizons)):
            plan = self._plan_model(key, req, fit, lead, measured, now,
                                    floor_allowed=key not in no_floor_keys,
                                    forecast_value=(
                                        chosen[i] if chosen is not None
                                        else None))
            plans.append(plan)
            if plan.floor_replicas > 0 and plan.variant_name:
                floors.append({
                    "namespace": plan.namespace,
                    "model_id": plan.model_id,
                    "variant_name": plan.variant_name,
                    "floor_replicas": plan.floor_replicas,
                    "reason": plan.reason,
                })
        return plans, floors

    def _plan_model(self, key: str, req, fit: dict[str, float],
                    lead: float, measured: bool, now: float,
                    floor_allowed: bool = True,
                    forecast_value: float | None = None) -> ForecastPlan:
        demand = max(req.result.total_demand, 0.0)
        plan = ForecastPlan(
            model_id=req.model_id, namespace=req.namespace, demand=demand,
            lead_time_seconds=round(lead, 1), lead_time_measured=measured,
            forecasts={name: fit[name] for name in fc.FORECASTERS})
        with self._mu:
            self._score_matured(key, now)
            pend = self._pending.setdefault(key, deque(maxlen=MAX_PENDING))
            pend.append(_Pending(due=now + lead, horizon=lead,
                                 forecasts=dict(fit)))
            for name in fc.FORECASTERS:
                err, evals = self._errors.get((key, name), (0.0, 0))
                plan.errors[name] = round(err, 6)
                plan.evals[name] = evals
            best, best_err, best_evals = self._best_trusted_locked(key)
        # The fused plane's device gather already selected this model's
        # forecast through the trust-index column; the gathered value is
        # bitwise the registry array element the staged reads below pick
        # (same device array), so either source yields the same plan.
        if forecast_value is None:
            forecast_value = fit[best if best is not None else "linear"]
        if best is None:
            plan.forecaster = "linear"  # floor of the registry, untrusted
            plan.forecast_demand = forecast_value
            plan.reason = (f"forecast untrusted ({self.min_trust_evals} "
                           "scored backtests required); reactive")
        elif best_err > self.demote_error_threshold:
            plan.forecaster = best
            plan.forecast_demand = forecast_value
            plan.demoted = True
            plan.reason = (f"forecast demoted: best rolling error "
                           f"{best_err:.2f} > "
                           f"{self.demote_error_threshold:.2f}; reactive")
        else:
            plan.trusted = True
            plan.forecaster = best
            plan.forecast_demand = forecast_value
            if floor_allowed:
                self._maybe_floor(plan, req, best_evals)
            else:
                plan.reason = ("fleet (global) optimizer owns this model's "
                               "placement; forecast floor withheld")
        with self._mu:
            self._last_plan[key] = plan
        return plan

    def _maybe_floor(self, plan: ForecastPlan, req, evals: int) -> None:
        """Proactive floor: replicas to serve the forecast at landing time,
        on the variant the current decisions favor. Growth-gated so a
        steady or falling forecast never perturbs reactive behavior."""
        if plan.forecast_demand < self.prewake_min_demand:
            # Noise gate, same threshold as the pre-wake: at zero observed
            # demand the growth ratio passes for ANY epsilon forecast
            # (seasonal residue of 0.01), and a floor of 1 replica would
            # override the enforcer's scale-to-zero every tick — demand
            # below the act-on-it threshold stays reactive.
            plan.reason = (f"forecast {plan.forecast_demand:.2f} below "
                           f"minimum actionable demand "
                           f"{self.prewake_min_demand:.2f}; reactive")
            return
        if plan.forecast_demand <= max(plan.demand, 1e-9) \
                * self.growth_min_ratio:
            plan.reason = (f"forecast {plan.forecast_demand:.2f} within "
                           f"{self.growth_min_ratio:.2f}x of demand "
                           f"{plan.demand:.2f}; reactive")
            return
        best_vc = None
        for vc in req.result.variant_capacities:
            if vc.per_replica_capacity <= 0:
                continue
            rank = (-vc.replica_count, vc.cost, vc.variant_name)
            if best_vc is None or rank < best_vc[0]:
                best_vc = (rank, vc)
        if best_vc is None:
            plan.reason = "no variant with known per-replica capacity"
            return
        vc = best_vc[1]
        floor = math.ceil(plan.forecast_demand
                          / (vc.per_replica_capacity
                             * self.target_utilization))
        plan.floor_replicas = int(floor)
        plan.variant_name = vc.variant_name
        plan.reason = (
            f"forecast[{plan.forecaster}] {plan.forecast_demand:.2f} at "
            f"now+{plan.lead_time_seconds:.0f}s "
            f"({'measured' if plan.lead_time_measured else 'default'} "
            f"lead time, {evals} backtests) -> floor {floor} replicas")

    def _evict_dead_keys(self, now: float) -> None:
        """Per-tick hygiene: the history store's time-based idle eviction
        is the source of truth for which models still matter (a
        scaled-to-zero model stays live as long as its rings do, so
        pre-wake keeps working); every other per-key state — pending
        backtests, rolling errors, plans, throttles, lead-time samples —
        follows it. Without this, a long-lived controller with model churn
        accumulates dead entries forever (the same leak class the
        DemandTrend idle sweep fixes)."""
        if not self.history.evict_idle(now):
            return
        live = set(self.history.keys())
        with self._mu:
            for d in (self._pending, self._last_plan,
                      self._last_prewake_check, self._accel_by_key,
                      self._demand_scale):
                for k in [k for k in d if k not in live]:
                    del d[k]
            for k in [k for k in self._errors if k[0] not in live]:
                del self._errors[k]
        self.leadtime.evict_missing(live)

    def _best_trusted_locked(self, key: str) -> tuple[str | None, float, int]:
        """(forecaster, rolling error, evals) with the lowest rolling error
        among those past the trust gate, or (None, inf, 0). THE trust rule
        — the floor path and the pre-wake path must never disagree on which
        forecaster is trusted. Caller holds the lock."""
        best, best_err, best_evals = None, float("inf"), 0
        for name in fc.FORECASTERS:
            err, evals = self._errors.get((key, name), (0.0, 0))
            if evals >= self.min_trust_evals and err < best_err:
                best, best_err, best_evals = name, err, evals
        return best, best_err, best_evals

    # -- rolling backtest scoring --

    def _score_matured(self, key: str, now: float) -> None:
        """Score pending forecasts whose target time has arrived against
        realized demand (symmetric MAPE, EWMA-smoothed). Caller holds
        the lock."""
        pend = self._pending.get(key)
        if not pend:
            return
        while pend and pend[0].due <= now:
            entry = pend.popleft()
            realized = self._realized_at(key, entry.due)
            if realized is None:
                continue
            scale = self._demand_scale.get(key, abs(realized))
            scale += 0.1 * (abs(realized) - scale)
            self._demand_scale[key] = scale
            denom_floor = max(0.05 * scale, 1e-6)
            for name, predicted in entry.forecasts.items():
                err = (abs(predicted - realized)
                       / max((abs(predicted) + abs(realized)) / 2.0,
                             denom_floor))
                err = min(err, 2.0)
                old, n = self._errors.get((key, name), (0.0, 0))
                a = self.error_ewma_alpha if n else 1.0
                self._errors[(key, name)] = (old + a * (err - old), n + 1)

    def _realized_at(self, key: str, t: float) -> float | None:
        """Observed demand nearest ``t`` (within tolerance), from the fine
        ring."""
        windows = self.history.windows(key)
        if windows is None:
            return None
        w = windows[0]
        if len(w) == 0:
            return None
        tol = REALIZED_TOLERANCE_STEPS * self.grid_step
        i = bisect_left(w.ts, t, w.lo, w.hi)
        best = None
        for j in (i - 1, i):
            if w.lo <= j < w.hi:
                dt = abs(w.ts[j] - t)
                if dt <= tol and (best is None or dt < best[0]):
                    best = (dt, w.vals[j])
        return best[1] if best else None

    def _grids_for(self, key: str, now: float, lead: float) -> fc.SeriesGrids:
        windows = self.history.windows(key)
        if windows is None:
            fine, nf = [0.0] * fc.N_GRID, 0
            longg, nl = [0.0] * fc.N_GRID, 0
        else:
            fine, nf = fc.resample(windows[0], now, self.grid_step)
            longg, nl = fc.resample(windows[1], now, self.long_step)
        return fc.SeriesGrids(
            fine=fine, fine_valid=nf, long=longg, long_valid=nl,
            h_fine_steps=lead / self.grid_step,
            h_long_steps=lead / self.long_step,
            season_steps=fc.SEASON_STEPS)

    # -- consumers --

    def lead_time_for(self, namespace: str,
                      model_id: str) -> tuple[float, bool]:
        return self._estimate_lead(self.key_for(namespace, model_id))

    def last_plan(self, namespace: str, model_id: str) -> ForecastPlan | None:
        with self._mu:
            return self._last_plan.get(self.key_for(namespace, model_id))

    def should_prewake(self, namespace: str, model_id: str,
                       now: float) -> tuple[bool, str]:
        """Scale-from-zero pre-wake: wake a scaled-to-zero model when a
        TRUSTED forecaster predicts demand >= ``prewake_min_demand`` at
        (now + lead time). Called from the scale-from-zero engine's 100ms
        loop — throttled per model, and it records the observed zero-demand
        samples so the seasonal fit keeps learning through the quiet phase."""
        if not self.prewake_enabled:
            return False, ""
        key = self.key_for(namespace, model_id)
        with self._mu:
            last = self._last_prewake_check.get(key, float("-inf"))
            if now - last < self.prewake_check_interval:
                return False, ""
            self._last_prewake_check[key] = now
        # A scaled-to-zero model serves zero demand — record it BEFORE any
        # trust gating, so the seasonal grids see the quiet phase instead
        # of LOCF'ing the last active sample forward (an untrusted model
        # must keep learning its real pattern through the idle phase, or
        # it would re-earn trust later against fabricated demand).
        self.history.observe(key, now, 0.0)
        with self._mu:
            self._score_matured(key, now)
            best, best_err, _ = self._best_trusted_locked(key)
        if best is None or best_err > self.demote_error_threshold:
            return False, ""
        lead, measured = self._estimate_lead(key)
        fit = fc.fit_batch([self._grids_for(key, now, lead)],
                           self.device)[0]
        forecast = fit[best]
        if forecast < self.prewake_min_demand:
            return False, ""
        return True, (
            f"forecast pre-wake: {best} predicts demand {forecast:.2f} >= "
            f"{self.prewake_min_demand:.2f} at now+{lead:.0f}s "
            f"({'measured' if measured else 'default'} lead time)")

    def stats(self, now: float):
        """History-store stats keyed by model key (for trend/forecast
        gauges)."""
        return self.history.stats(now)

    # -- crash-restart checkpoint (wva_tpu_torch.resilience) --

    def export_trust(self) -> dict:
        """Serializable trust state for the resilience checkpoint: rolling
        backtest errors (the trust gate's entire evidence base — weeks of
        matured evaluations a restart would otherwise discard), the
        per-model demand scale the error denominator floors on, and the
        dominant-accelerator map lead-time fallbacks key on. Pending
        (not-yet-matured) forecasts are NOT exported — they score against
        the in-memory demand history, which does not survive either.
        Sorted everywhere: equal state serializes byte-identically."""
        with self._mu:
            return {
                "errors": [[key, name, err, evals]
                           for (key, name), (err, evals)
                           in sorted(self._errors.items())],
                "demand_scale": [[k, v] for k, v
                                 in sorted(self._demand_scale.items())],
                "accel": [[k, v] for k, v
                          in sorted(self._accel_by_key.items())],
            }

    def restore_trust(self, state: dict) -> int:
        """Rehydrate from :meth:`export_trust` output (boot warm-start).
        A restored model whose best forecaster already passed the trust
        gate resumes proactive floors as soon as fresh demand history
        rebuilds — instead of re-earning ``min_trust_evals`` matured
        backtests from scratch after every restart. Returns how many
        (model, forecaster) error entries were restored."""
        restored = 0
        with self._mu:
            for key, name, err, evals in state.get("errors", []):
                self._errors[(str(key), str(name))] = \
                    (float(err), int(evals))
                restored += 1
            for key, value in state.get("demand_scale", []):
                self._demand_scale[str(key)] = float(value)
            for key, accel in state.get("accel", []):
                self._accel_by_key[str(key)] = str(accel)
        return restored
