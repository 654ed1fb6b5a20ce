"""Online service-parameter tuner: an Extended Kalman Filter re-estimating
the iteration-time parameters (alpha, beta, gamma) from observed TTFT/ITL.

Successor of the reference's dormant tuner
(``internal/engines/analyzers/queueingmodel/tuner/tuner.go:15-287``), which
delegates to an external EKF library (``llm-inferno/kalman-filter`` + gonum)
with numerically propagated Jacobians. The TPU-native redesign differentiates
straight through the batched M/M/1-SD chain solver: h(x) = (TTFT, ITL)
predicted by the queueing model at the observed arrival rate, and H = dh/dx
exact to machine precision, by forward mode. On the card h and H are one
launch of the hand-written CUDA kernel in :mod:`.jacobian_kernel` (dual
numbers through the 2048-state chain); on CPU tensors they come from the
plain version, ``torch.func.jacfwd`` through the queueing model. The step's
inputs go up in one host-to-device copy and h and H come back in one.

Acceptance follows the reference's NIS gate
(``tuner/defaults.go:12-19``): under nominal conditions the Normalized
Innovations Squared follows a chi-squared distribution with dof = observation
dimension (2); updates outside the 95% confidence bound (7.378) are rolled
back so a burst of anomalous telemetry cannot corrupt the state
(``tuner.go:108-133`` stash/unstash).
"""

from __future__ import annotations

import logging
import math
import threading
from dataclasses import dataclass, field
import numpy as np
import torch

from wva_tpu_torch.analyzers.queueing import jacobian_kernel
from wva_tpu_torch.analyzers.queueing.params import (
    K_MAX,
    PerfProfileStore,
    ServiceParms,
)
from wva_tpu_torch.analyzers.queueing.queue_model import (
    CandidateBatch,
    _chain_stats,
    _derived_latencies,
    rate_bounds_per_ms,
)
from wva_tpu_torch.device import resolve_device
from wva_tpu_torch.obs.spans import scoped

log = logging.getLogger(__name__)

# 95% chi-squared bound, dof=2 (reference tuner/defaults.go:12-19).
DEFAULT_MAX_NIS = 7.378

STATE_ALPHA, STATE_BETA, STATE_GAMMA = 0, 1, 2


@dataclass
class TunerEnvironment:
    """Operating point the observations were taken at
    (reference tuner/environment.go:10-28)."""

    lambda_per_min: float = 0.0  # request arrival rate (per minute)
    avg_input_tokens: float = 0.0
    avg_output_tokens: float = 0.0
    max_batch_size: int = 0
    # Queue bound of the observed server; 0 falls back to
    # max_batch * max_queue_to_batch_ratio. MUST match the profile used by
    # the sizer so the EKF fits the same queue the capacity model solves.
    max_queue_size: int = 0
    avg_ttft_ms: float = 0.0  # observed
    avg_itl_ms: float = 0.0  # observed
    # Fleet-average decode-slot occupancy (0-1) at observation time; -1 =
    # unknown. Used by the informativeness gate (TunerConfig.min_occupancy):
    # near-idle operating points cannot identify the batch-dependent terms —
    # observed TTFT there is just the size-dependent floor, and fitting it
    # drags beta to a state that matches idle latency while collapsing the
    # predicted capacity at load.
    occupancy: float = -1.0
    # Fleet-average KV-cache usage (0-1) at observation time; -1 = unknown.
    # A FALLBACK idle signal for collectors without slot telemetry (vLLM):
    # KV usage is a DIFFERENT scale from decode-slot occupancy (one
    # long-context request can fill half the KV cache at batch 1; hundreds
    # of short requests can batch heavily at a few percent KV), so it is
    # only ever compared against its own near-idle threshold
    # (TunerConfig.min_kv_usage), never against min_occupancy.
    kv_occupancy: float = -1.0

    def valid(self) -> bool:
        vals = [self.lambda_per_min, self.avg_input_tokens,
                self.avg_output_tokens, self.avg_ttft_ms, self.avg_itl_ms]
        return (all(v > 0 and math.isfinite(v) for v in vals)
                and self.max_batch_size > 0)


@dataclass
class TunerConfig:
    """Filter tuning knobs (reference tuner/types.go:9-25, with the
    reference's (errorLevel/tPercentile)^2/gammaFactor observation-noise
    construction collapsed into one fraction)."""

    # Expected 1-sigma relative change of each state param per step -> Q.
    percent_change: tuple[float, float, float] = (0.05, 0.05, 0.05)
    # Relative 1-sigma observation noise on (TTFT, ITL) -> R.
    observation_noise_frac: float = 0.10
    max_nis: float = DEFAULT_MAX_NIS
    min_state: tuple[float, float, float] = (1e-4, 0.0, 0.0)
    max_state: tuple[float, float, float] = (1e4, 10.0, 10.0)
    # Re-acquisition: after this many consecutive NIS rejections the state
    # covariance is inflated so the filter can converge from a badly wrong
    # prior instead of rejecting forever (an improvement over the reference,
    # which rolls back unconditionally, tuner.go:108-133 — a misfit initial
    # profile there pins the filter permanently).
    max_consecutive_rejections: int = 3
    covariance_inflation: float = 10.0
    # Trust region: bound each accepted step to this relative change per
    # component (with ``min_step`` as the absolute floor so components near
    # zero can still move). The EKF linearization is only local; an inflated
    # covariance otherwise produces a near-Newton jump that can overshoot
    # past the valid neighborhood, slam into ``min_state``, and leave the
    # filter permanently NIS-rejecting — observed under repeated
    # observations at one operating point, which is the NORMAL engine
    # regime (30s ticks under slowly-varying load).
    max_step_frac: float = 0.3
    min_step: tuple[float, float, float] = (0.5, 1e-3, 1e-5)
    # Hard re-acquisition: after this many consecutive rejections (i.e.
    # repeated inflation didn't get NIS under the bound — the model, not the
    # telemetry, is wrong) accept one trust-region-bounded step anyway and
    # re-seed the covariance from the new state.
    reacquire_after: int = 9
    # Queue bound used by the observation model, as a multiple of max batch
    # (reference config.MaxQueueToBatchRatio).
    max_queue_to_batch_ratio: int = 4
    # Informativeness gate: skip filter steps when the fleet's decode-slot
    # occupancy is below this (and known). alpha/beta/gamma are only jointly
    # identifiable when batching actually happens; at near-idle every
    # (alpha, beta) pair on a line predicts the same observation, and the
    # EKF walks along that line to wherever the idle-latency floor points —
    # a state that can mispredict capacity by orders of magnitude. Freezing
    # at idle keeps the last loaded-regime fit, which is the regime sizing
    # decisions are made in. 0.05 = a handful of occupied slots: below it
    # the batch-dependent terms move predictions by less than the
    # observation noise.
    min_occupancy: float = 0.05
    # Binary idle gate for the KV-usage FALLBACK signal (slot telemetry
    # absent): below this the fleet is effectively not decoding and the
    # observation is uninformative; above it the filter steps — KV usage
    # carries no batch-size information, so no finer comparison is sound
    # (a 0.03 KV fleet can be batching 50 short requests per replica).
    min_kv_usage: float = 0.02


@dataclass
class TunedResults:
    """Outcome of one filter step (reference tuner/tuner.go:21-27)."""

    service_parms: ServiceParms
    innovation: tuple[float, float] = (0.0, 0.0)
    nis: float = -1.0
    validation_failed: bool = False


def _observe_and_jacobian(x: torch.Tensor,
                          env: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """h(x) = (TTFT_ms, ITL_ms) predicted at the environment's operating
    point, plus H = dh/dx via forward-mode autodiff through the chain solver.

    x = [alpha, beta, gamma]; env = [lam_per_ms, avg_in, avg_out, max_batch, k],
    both float32 on one device; h and H come back on that device.
    """
    hh = _observation(x, env)
    return hh[:, 0], hh[:, 1:]


def _observation(x: torch.Tensor, env: torch.Tensor) -> torch.Tensor:
    """h in column 0 and H in columns 1-3 of one ``[2, 4]`` tensor. CUDA
    tensors take one launch of the kernel (raising if it cannot launch, or
    if x and env are not on one card); CPU tensors the plain version."""
    if x.device.type == "cpu" and env.device.type == "cpu":
        h, jac = observe_and_jacobian_plain(x, env)
        return torch.cat([h[:, None], jac], dim=1)
    return jacobian_kernel.launch(x, env)


def observe_and_jacobian_plain(
        x: torch.Tensor, env: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: h and H by ``torch.func.jacfwd`` through
    the queueing model's PyTorch ops, on x and env's device."""

    def h(params: torch.Tensor) -> torch.Tensor:
        cand = CandidateBatch(
            alpha=params[0:1],
            beta=params[1:2],
            gamma=params[2:3],
            avg_input_tokens=env[1:2],
            avg_output_tokens=env[2:3],
            max_batch=env[3:4].to(torch.int32),
            k=env[4:5].to(torch.int32),
        )
        lam_min, lam_max = rate_bounds_per_ms(cand)
        # jnp.clip's order: the lower bound first, then the upper.
        lam = torch.minimum(torch.maximum(env[0:1], lam_min), lam_max)
        stats = _chain_stats(lam, cand)
        _, itl, ttft = _derived_latencies(stats, cand)
        return torch.stack([ttft[0], itl[0]])

    return h(x), torch.func.jacfwd(h)(x)


class KalmanTuner:
    """EKF over one (model, accelerator) profile's service parameters."""

    def __init__(self, init: ServiceParms, config: TunerConfig | None = None,
                 device=None) -> None:
        if not init.valid():
            raise ValueError(f"invalid initial service parms: {init}")
        self.config = config or TunerConfig()
        # Where h and H are computed (None: the CUDA card); the filter's
        # algebra stays numpy float64 on the host.
        self.device = resolve_device(device)
        self.x = np.array([init.alpha, init.beta, init.gamma], dtype=np.float64)
        # P0 and Q from expected relative change (reference
        # configurator.go:82-91 GetStateCov).
        self._reseed_covariance()
        self.steps = 0
        self.rejected = 0
        self._consecutive_rejections = 0

    def _q(self) -> np.ndarray:
        pc = np.asarray(self.config.percent_change, dtype=np.float64)
        return np.diag(np.maximum((pc * self.x) ** 2, 1e-12))

    def _r(self, z: np.ndarray) -> np.ndarray:
        frac = self.config.observation_noise_frac
        return np.diag(np.maximum((frac * z) ** 2, 1e-9))

    def run(self, env: TunerEnvironment, spans=None) -> TunedResults:
        """One predict/update step against the observed environment
        (reference tuner.go:82-143). On NIS rejection the previous state is
        kept and returned with ``validation_failed=True``. With a span
        recorder (``obs.spans``), h and H's launch and read back are the
        span ``h_jacobian``; the rest of the step is the host's algebra."""
        if not env.valid():
            raise ValueError(f"cannot run tuner with invalid environment: {env}")
        cfg = self.config
        if env.max_queue_size > 0:
            k_bound = min(env.max_batch_size + env.max_queue_size, K_MAX)
        else:
            k_bound = min(env.max_batch_size * (1 + cfg.max_queue_to_batch_ratio),
                          K_MAX)
        # x and env go up in one host-to-device copy.
        inputs = torch.tensor([
            *self.x,
            env.lambda_per_min / 60_000.0,  # per-minute -> per-ms
            env.avg_input_tokens,
            env.avg_output_tokens,
            float(env.max_batch_size),
            float(k_bound),
        ], dtype=torch.float32, device=self.device)
        z = np.array([env.avg_ttft_ms, env.avg_itl_ms], dtype=np.float64)

        x_prev, p_prev = self.x.copy(), self.P.copy()

        # Predict (identity transition; reference stateTransitionFunc).
        p_pred = self.P + self._q()

        # One device->host read for h and H together.
        with scoped(spans, "h_jacobian"):
            hh = _observation(inputs[:3], inputs[3:]).cpu().numpy()
        h_val = hh[:, 0].astype(np.float64)
        H = hh[:, 1:].astype(np.float64)

        r = self._r(z)
        y = z - h_val
        s = H @ p_pred @ H.T + r
        try:
            s_inv = np.linalg.inv(s)
        except np.linalg.LinAlgError:
            return TunedResults(service_parms=self._parms(), innovation=tuple(y),
                                nis=-1.0, validation_failed=True)
        nis = float(y @ s_inv @ y)

        gain = p_pred @ H.T @ s_inv
        x_new = self._bounded_step(gain @ y)
        eye = np.eye(3)
        # Joseph form keeps P symmetric positive semi-definite.
        p_new = (eye - gain @ H) @ p_pred @ (eye - gain @ H).T + gain @ r @ gain.T

        self.steps += 1
        if not math.isfinite(nis) or nis > cfg.max_nis or not np.all(
                np.isfinite(x_new)):
            self.x, self.P = x_prev, p_prev
            self.rejected += 1
            self._consecutive_rejections += 1
            if (self._consecutive_rejections >= cfg.reacquire_after
                    and np.all(np.isfinite(x_new))):
                # Inflation alone didn't bring NIS under the bound: the
                # state, not the telemetry, is wrong (e.g. a badly misfit
                # static profile under steady load, where every tick repeats
                # the same operating point). Accept one bounded step toward
                # the observation and re-seed P from the new state — the
                # filter walks to the telemetry in <= 1/max_step_frac steps
                # instead of rejecting forever.
                self.x = x_new
                self._reseed_covariance()
                self._consecutive_rejections = 0
                return TunedResults(service_parms=self._parms(),
                                    innovation=tuple(y), nis=nis,
                                    validation_failed=False)
            if self._consecutive_rejections % max(
                    cfg.max_consecutive_rejections, 1) == 0:
                # Persistent mismatch: the prior, not the telemetry, is wrong.
                # Inflate P so subsequent steps can move the state.
                self.P = self.P * cfg.covariance_inflation
            return TunedResults(service_parms=self._parms(), innovation=tuple(y),
                                nis=nis, validation_failed=True)

        self._consecutive_rejections = 0
        self.x, self.P = x_new, p_new
        return TunedResults(service_parms=self._parms(), innovation=tuple(y),
                            nis=nis, validation_failed=False)

    def _bounded_step(self, delta: np.ndarray) -> np.ndarray:
        """Apply ``delta`` to the state under the trust region: each
        component moves at most max_step_frac relative (min_step absolute
        floor), and the result stays inside [min_state, max_state]."""
        cfg = self.config
        bound = np.maximum(cfg.max_step_frac * np.abs(self.x),
                           np.asarray(cfg.min_step, dtype=np.float64))
        return np.clip(self.x + np.clip(delta, -bound, bound),
                       cfg.min_state, cfg.max_state)

    def _reseed_covariance(self) -> None:
        """P0-style covariance around the current state (used after hard
        re-acquisition so P reflects the moved state, not the inflated
        history)."""
        pc = np.asarray(self.config.percent_change, dtype=np.float64)
        self.P = np.diag(np.maximum(
            (pc * self.x) ** 2,
            (pc * np.asarray(self.config.min_step, dtype=np.float64)) ** 2))

    def _parms(self) -> ServiceParms:
        return ServiceParms(alpha=float(self.x[STATE_ALPHA]),
                            beta=float(self.x[STATE_BETA]),
                            gamma=float(self.x[STATE_GAMMA]))


class TunerController:
    """Owns one :class:`KalmanTuner` per (namespace, model, accelerator) and
    writes accepted refinements back to the :class:`PerfProfileStore` (the
    write-back path the reference never wired in — ``tuner.go`` is reachable
    only from tests there; SURVEY.md section 2 L(-1))."""

    def __init__(self, profiles: PerfProfileStore,
                 config: TunerConfig | None = None, device=None) -> None:
        self.profiles = profiles
        self.config = config or TunerConfig()
        # Where every tuner's h and H are computed (None: the CUDA card).
        self.device = resolve_device(device)
        self._mu = threading.Lock()
        self._tuners: dict[tuple[str, str, str], KalmanTuner] = {}

    def observe(self, namespace: str, model_id: str, accelerator: str,
                env: TunerEnvironment, spans=None) -> TunedResults | None:
        """Feed one telemetry sample; returns the step result, or None when
        there is no profile to refine / the environment is unusable.
        ``spans`` is handed to the step (:meth:`KalmanTuner.run`)."""
        if not env.valid():
            return None
        if 0.0 <= env.occupancy < self.config.min_occupancy:
            log.debug("Tuner skipping (%s, %s, %s): occupancy %.2f below "
                      "identifiability gate %.2f", namespace, model_id,
                      accelerator, env.occupancy, self.config.min_occupancy)
            return None
        if (env.occupancy < 0.0
                and 0.0 <= env.kv_occupancy < self.config.min_kv_usage):
            # No slot telemetry: KV usage serves only as a binary
            # idle/non-idle signal against ITS OWN threshold — comparing
            # it to min_occupancy mis-gated both directions (long-context/
            # low-batch passed as "busy"; short-request/high-batch was
            # skipped as "idle" and starved the filter of its most
            # informative regime).
            log.debug("Tuner skipping (%s, %s, %s): KV usage %.3f below "
                      "idle gate %.3f (no slot telemetry)", namespace,
                      model_id, accelerator, env.kv_occupancy,
                      self.config.min_kv_usage)
            return None
        profile = self.profiles.get(model_id, accelerator, namespace=namespace)
        if profile is None or not profile.service_parms.valid():
            return None
        if env.max_queue_size == 0:
            env.max_queue_size = profile.max_queue_size
        key = (namespace, model_id, accelerator)
        with self._mu:
            tuner = self._tuners.get(key)
            if tuner is None:
                tuner = KalmanTuner(profile.service_parms, self.config,
                                    device=self.device)
                self._tuners[key] = tuner
        result = tuner.run(env, spans=spans)
        if not result.validation_failed and result.service_parms.valid():
            self.profiles.update_service_parms(
                model_id, accelerator, result.service_parms,
                namespace=profile.namespace)
            log.debug("Tuner refined (%s, %s, %s): alpha=%.4f beta=%.5f "
                      "gamma=%.6f NIS=%.3f", namespace, model_id, accelerator,
                      result.service_parms.alpha, result.service_parms.beta,
                      result.service_parms.gamma, result.nis)
        return result
