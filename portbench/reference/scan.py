"""The policy sweep's fluid world: W worlds of M models each, stepped
``dt`` seconds at a time over the horizon, from its definition.

Each step, per (world, model): replicas that finished provisioning
become ready; the ready replicas serve the queue plus this step's
arrivals at full-batch throughput; arrivals whose estimated TTFT (queue
wait + prefill at the step's occupancy) is within the SLO, less those
dropped past the queue bound, are attained. The controller smooths the
observed rate (held through fault windows), on its own cadence updates a
Holt level/trend forecast with a walk-forward error that gates trust,
sizes replicas for the larger of the observed rate plus burst insurance
and the trusted forecast one provisioning lead ahead, adds headroom, and
moves its desired replicas: up at once, down only after the
stabilisation window and outside faults, not at all while frozen.
Scale-downs take effect at once, scale-ups through the provisioning
pipeline. Chip-seconds integrate the desired replicas; a wrong-direction
event is a scale-down while the true rate rises.

Knob rows are ``[W, 13]`` in ``KNOBS`` order; ``scenario`` holds the
world's physics (the keys of the traffic file's ``world``).
"""

from __future__ import annotations

import torch

KNOBS = ("engine_interval_s", "headroom_replicas", "target_utilization",
         "burst_slope_rps", "forecaster", "grid_step_s", "level_gain",
         "trend_gain", "min_trust_evals", "demote_error", "degraded_after_s",
         "freeze_after_s", "recovery_ticks")
EPS = 1e-6
ERR_GAIN = 0.2


def _steps(seconds: float, dt: float) -> int:
    return max(int(round(seconds / dt)), 1)


def run(scenario: dict, knob_rows, lam_t, arrivals, faults,
        init_replicas: float, dtype=torch.float64):
    """``knob_rows [W, 13]``, the true rates ``lam_t [T, M]``, arrivals
    and fault flags ``[T, W, M]``: returns (attainment, chip-seconds,
    wrong-direction events, arrivals), each ``[W, M]`` in ``dtype``."""
    s = scenario
    dev = knob_rows.device
    cast = lambda x: x.to(dtype=dtype, device=dev)  # noqa: E731
    knob = {n: cast(knob_rows[:, i:i + 1]) for i, n in enumerate(KNOBS)}
    lam_t, arrivals, faults = cast(lam_t), cast(arrivals), cast(faults)
    dt, batch = s["dt"], float(s["max_batch"])
    n_steps = _steps(s["horizon_s"], dt)
    lead = _steps(s["startup_s"], dt)
    stab = _steps(s["down_stabilization_s"], dt)
    tc = (s["avg_input_tokens"] + s["avg_output_tokens"]) \
        / (s["avg_output_tokens"] + 1.0)
    tm = s["avg_input_tokens"] + s["avg_output_tokens"] / 2.0
    slope = s["beta_ms"] * tc + s["gamma_ms"] * tm
    extra = (s["beta_ms"] + s["gamma_ms"]) * s["avg_input_tokens"]

    def prefill(n):
        return s["alpha_ms"] + n * slope + extra

    def replica_rps(n):  # requests a second one replica serves at batch n
        return 1000.0 * n / (prefill(n) + s["avg_output_tokens"]
                             * (s["alpha_ms"] + n * slope))

    t = lambda v: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
    rate_full = t(replica_rps(batch))
    occ_target = torch.clamp(knob["target_utilization"] * batch, 1.0, batch)
    g_obs = torch.clamp(dt / torch.maximum(knob["grid_step_s"], t(dt)),
                        0.0, 1.0)
    interval = knob["engine_interval_s"] / dt
    interval = torch.where(torch.isfinite(interval), torch.round(interval),
                           t(1.0))
    interval = torch.clamp(interval, 1.0, float(n_steps)).to(torch.int64)
    lead_intervals = lead / torch.clamp(interval.to(dtype), min=1.0) + 1.0
    r_target = torch.clamp(replica_rps(occ_target), min=EPS)
    burst = knob["burst_slope_rps"] * s["startup_s"]

    w, m = knob_rows.shape[0], lam_t.shape[1]
    zero = torch.zeros((w, m), dtype=dtype, device=dev)
    q = obs = level = trend = err = evals = zero
    fault_run = recovery = last_lam = attained = total = chip_s = wd = zero
    ready = desired = zero + init_replicas
    since_up = zero + stab
    pipe = [zero] * lead
    for step in range(n_steps):
        lam_now, a, f = lam_t[step], arrivals[step], faults[step]
        ready = ready + pipe[0]
        pipe = pipe[1:] + [zero]

        cap = ready * rate_full
        wait = q / torch.clamp(cap, min=EPS)
        occ = torch.clamp((q + a) / torch.clamp(cap * dt, min=EPS) * batch,
                          1.0, batch)
        ok = wait + prefill(occ) / 1000.0 <= s["slo_ttft_s"]
        backlog = q + a
        left = backlog - torch.minimum(backlog, cap * dt)
        drop = torch.clamp(left - s["queue_bound"] * ready, min=0.0)
        attained = attained + torch.clamp(torch.where(ok, a, zero) - drop,
                                          min=0.0)
        q = left - drop
        total = total + a

        faulted = f > 0
        obs = torch.where(faulted, obs, obs + g_obs * (a / dt - obs))
        fault_run = torch.where(faulted, fault_run + 1.0, zero)
        recovery = torch.where(faulted, knob["recovery_ticks"],
                               torch.clamp(recovery - 1.0, min=0.0))

        act = (step % interval) == 0
        update = act & ~faulted
        pred = level + trend
        rel_err = torch.abs(pred - obs) / torch.clamp(
            (torch.abs(pred) + torch.abs(obs)) / 2.0, min=EPS)
        err = torch.where(update, err + ERR_GAIN * (rel_err - err), err)
        evals = torch.where(update, evals + 1.0, evals)
        new_level = torch.where(
            update, knob["level_gain"] * obs
            + (1 - knob["level_gain"]) * (level + trend), level)
        trend = torch.where(
            update, knob["trend_gain"] * (new_level - level)
            + (1 - knob["trend_gain"]) * trend, trend)
        level = new_level
        trusted = (evals >= knob["min_trust_evals"]) \
            & (err <= knob["demote_error"])
        forecast = level + trend * lead_intervals
        want = torch.maximum(obs + burst, torch.where(trusted, forecast,
                                                      zero))
        raw = torch.clamp(torch.ceil(want / r_target)
                          + knob["headroom_replicas"], 1.0,
                          float(s["max_replicas"]))

        fault_s = fault_run * dt
        degraded = fault_s >= knob["degraded_after_s"]
        frozen = fault_s >= knob["freeze_after_s"]
        can_down = (since_up >= stab) & ~degraded & (recovery <= 0)
        new = torch.where((raw > desired) | can_down, raw, desired)
        new = torch.where(frozen | ~act, desired, new)
        wd = wd + (act & (new < desired)
                   & (lam_now > last_lam + EPS)).to(dtype)
        last_lam = torch.where(act, zero + lam_now, last_lam)
        since_up = torch.where(act & (new > desired), zero, since_up + 1.0)
        desired = new

        pending = sum(pipe[1:], pipe[0])
        ready = ready - torch.clamp(ready - desired, min=0.0)
        short = torch.clamp(desired - (ready + pending), min=0.0)
        pipe[-1] = pipe[-1] + short
        chip_s = chip_s + desired * s["chips_per_replica"] * dt

    return (attained / torch.clamp(total, min=1.0), chip_s, wd, total)
