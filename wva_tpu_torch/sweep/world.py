"""The vectorized emulated world: ``[W, M]`` grids of policy worlds,
each chunk advanced over the whole horizon by one launch of a CUDA kernel
on the card (``csrc/world_scan.cu``, :mod:`wva_tpu_torch.sweep.scan_kernel`),
as the reference runs one ``jit(lax.scan)`` dispatch per chunk; on the CPU
by its plain version, a loop of PyTorch steps.

Physics, re-expressed fluidly from the event-driven twin:

- **Serving** mirrors ``emulator/server_sim.py``'s batch-aware latency
  law — ``T(n) = alpha + n*(beta*tc + gamma*tm)`` ms per decode
  iteration, prefill ``T(n) + (beta+gamma)*in_tokens`` — through the
  queueing model's per-replica service rate
  (``analyzers/queueing/queue_model.py _service_rate``):
  ``r(n) = n / (prefill(n) + out_tokens * T(n))`` requests/ms. A step
  serves ``min(queue + arrivals, ready * r(B_max) * dt)`` and estimates
  TTFT as queue-wait + prefill at the operating occupancy; arrivals
  whose estimate exceeds the SLO (or that overflow the per-replica queue
  bound) are misses — the fluid analog of ``slo_attainment`` counting
  unserved arrivals against the target.
- **Scaling dynamics** mirror the harness: desired replicas actuate
  through a ``startup_s``-deep provisioning pipeline (scale-ups become
  ready one lead later; scale-downs are immediate), scale-down waits out
  a stabilization window, and chip-seconds integrate DESIRED replicas —
  exactly the bench's cost integral.
- **The controller** is the knob-parameterized fluid policy: EWMA
  observed rate (``grid_step_s`` window, stale-held through fault
  windows), a Holt level/trend forecast (``level_gain``/``trend_gain``,
  the EKF-prior analog) projected one provisioning lead ahead and
  trust-gated by ``min_trust_evals``/``demote_error`` walk-forward
  error, burst-slope anticipation, headroom replicas, and the health
  plane's degraded/freeze/recovery thresholds over seeded fault windows.

Everything is fixed-shape and branch-free (masks, never Python branches
on tensor values), so per-world results are **bitwise independent of the
batch width** — world ``w`` computes the identical float32 lane whether
it rides in a chunk of 1 or 256 (asserted by
``tests/test_torch_sweep.py``, and on the card by
``tests/test_torch_sweep_kernel.py`` and ``chip_smoke.py``). All randomness (Poisson arrivals, fault
windows) is precomputed on the host from per-world seeds
(``numpy.random.Philox`` / :mod:`wva_tpu_torch.utils.seeds`), keyed by the
world seed alone — never by batch position — so :func:`run_worlds` builds
a seed's tables once however many worlds share it.

:func:`run_world_python` is the same recurrence as a per-world scalar
Python loop — the honest baseline ``make bench-sweep`` quotes the
vectorized throughput against, and the cross-check the tests pin the
device program to.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
import numpy as np
import torch

from wva_tpu_torch.device import resolve_device
from wva_tpu_torch.sweep import knobs as kb
from wva_tpu_torch.sweep import scan_kernel
from wva_tpu_torch.utils import dispatch, seeds

_EPS = 1e-6
# Objective score assigned to NaN / degenerate / non-finite worlds: a
# loss no healthy world can reach, so they can never win a sweep.
LOSS_SCORE = -1.0e9


@dataclass(frozen=True)
class WorldParams:
    """The scenario: serving physics + scaling dynamics + horizon (world
    -invariant; knobs vary per world, these do not). Defaults match the
    north-star bench scenario (bench.py TRUE_PARMS et al.)."""

    alpha_ms: float = 18.0
    beta_ms: float = 0.00267
    gamma_ms: float = 0.00002
    avg_input_tokens: float = 512.0
    avg_output_tokens: float = 256.0
    max_batch: int = 96
    queue_bound: int = 64          # per-replica admission bound
    chips_per_replica: int = 8
    slo_ttft_s: float = 1.0
    startup_s: float = 120.0       # provisioning + model load lead
    down_stabilization_s: float = 120.0
    dt: float = 5.0                # step = one fast engine tick
    horizon_s: float = 2400.0
    max_replicas: int = 32
    # Objective weights: attainment minus normalized chip-seconds minus
    # wrong-direction events (the bench objective's three axes).
    cost_weight: float = 0.25
    wrong_direction_weight: float = 0.02
    # Seeded input-fault windows (health-knob pressure): mean gap between
    # fault windows and their duration; 0 gap disables.
    fault_mean_gap_s: float = 600.0
    fault_duration_s: float = 90.0

    @property
    def steps(self) -> int:
        return int(round(self.horizon_s / self.dt))

    @property
    def lead_steps(self) -> int:
        return max(int(round(self.startup_s / self.dt)), 1)


# -- the shared latency law (scalar, used by both the python reference
# -- and, through tensor broadcasting, the device program) ---------------

def _iteration_slope(p: WorldParams) -> float:
    """ms an iteration per request in the batch, ``beta*tc + gamma*tm``."""
    tc = (p.avg_input_tokens + p.avg_output_tokens) \
        / (p.avg_output_tokens + 1.0)
    tm = p.avg_input_tokens + p.avg_output_tokens / 2.0
    return p.beta_ms * tc + p.gamma_ms * tm


def _prefill_extra(p: WorldParams) -> float:
    """Prefill's ms beyond one iteration, ``(beta+gamma) * in_tokens``."""
    return (p.beta_ms + p.gamma_ms) * p.avg_input_tokens


def iteration_ms(p: WorldParams, n, xp=math):  # noqa: ARG001 — xp unused
    return p.alpha_ms + n * _iteration_slope(p)


def prefill_ms(p: WorldParams, n):
    return iteration_ms(p, n) + _prefill_extra(p)


def replica_rps(p: WorldParams, n):
    """Per-replica sustainable throughput (req/s) at batch occupancy
    ``n`` — ``queue_model._service_rate`` scaled from req/ms."""
    denom = prefill_ms(p, n) + p.avg_output_tokens * iteration_ms(p, n)
    return 1000.0 * n / denom


# -- host-side seeded inputs --------------------------------------------

def rate_table(profiles, params: WorldParams) -> np.ndarray:
    """``[M, T]`` float32 true-rate table from loadgen profiles' pure
    ``rate_at`` forms, sampled at step midpoints."""
    t = (np.arange(params.steps, dtype=np.float64) + 0.5) * params.dt
    rows = []
    for prof in profiles:
        rate_at = getattr(prof, "rate_at", None)
        if rate_at is not None:
            rows.append(np.asarray(rate_at(t), dtype=np.float64))
        else:  # plain callable fallback (scalar closure per instant)
            rows.append(np.array([float(prof(x)) for x in t]))
    return np.maximum(np.asarray(rows, dtype=np.float64), 0.0) \
        .astype(np.float32)


def arrivals_table(world_seeds, lam: np.ndarray,
                   params: WorldParams) -> np.ndarray:
    """``[W, M, T]`` seeded Poisson arrivals (requests per step). One
    counter-based Philox stream per world, keyed by the world seed alone
    — batch composition can never perturb a world's draw."""
    out = np.empty((len(world_seeds),) + lam.shape, dtype=np.float32)
    expect = lam.astype(np.float64) * params.dt
    for i, s in enumerate(world_seeds):
        g = np.random.Generator(np.random.Philox(key=int(s) & (2**64 - 1)))
        out[i] = g.poisson(expect)
    return out


def fault_table(world_seeds, n_models: int,
                params: WorldParams) -> np.ndarray:
    """``[W, M, T]`` float32 0/1 input-fault windows: a seeded burst
    train per (world, model) (same recurrence as the chaos storms —
    :func:`wva_tpu_torch.utils.seeds.seeded_burst_starts`)."""
    mask = np.zeros((len(world_seeds), n_models, params.steps),
                    dtype=np.float32)
    if params.fault_mean_gap_s <= 0:
        return mask
    t = (np.arange(params.steps, dtype=np.float64) + 0.5) * params.dt
    for i, s in enumerate(world_seeds):
        for m in range(n_models):
            starts = seeds.seeded_burst_starts(
                seeds.crc_key(int(s), "sweep-fault", m),
                params.fault_mean_gap_s, params.fault_duration_s,
                params.horizon_s)
            for st in starts:
                window = (t >= st) & (t < st + params.fault_duration_s)
                mask[i, m] = np.maximum(mask[i, m],
                                        window.astype(np.float32))
    return mask


# -- the device program ---------------------------------------------------

class _Consts:
    """The program's float32 constants as 0-dim tensors on its device.
    Every division takes its divisor as a tensor: PyTorch's CUDA division
    by a Python number multiplies by its reciprocal, which rounds twice."""

    def __init__(self, dev: torch.device, **values: float) -> None:
        for name, v in values.items():
            setattr(self, name,
                    torch.tensor(v, dtype=torch.float32, device=dev))


def _clip(x, lo, hi):
    """``jnp.clip``'s order, ``minimum(maximum(x, lo), hi)``: NaN flows
    through."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _stab_steps(p: WorldParams) -> int:
    return max(int(round(p.down_stabilization_s / p.dt)), 1)


def scan_constants(params: WorldParams, init_replicas: float) -> dict:
    """The scan kernel's constants (``scan_kernel.CONSTANT_NAMES``): each
    the Python value :func:`run_chunk_plain` hands a PyTorch op, which
    rounds it to float32 once, as the kernel's wrapper does."""
    p = params
    return dict(
        eps=_EPS, dt=p.dt, ms=1000.0, max_batch=float(p.max_batch),
        max_replicas=float(p.max_replicas), steps=float(p.steps),
        lead=float(p.lead_steps), iter_slope=_iteration_slope(p),
        alpha=p.alpha_ms, prefill_extra=_prefill_extra(p),
        out_tokens=p.avg_output_tokens,
        rate_full=replica_rps(p, float(p.max_batch)),
        slo_ttft=p.slo_ttft_s, queue_bound=float(p.queue_bound),
        startup=p.startup_s, stab_steps=float(_stab_steps(p)),
        chips_per_replica=float(p.chips_per_replica),
        init_replicas=float(init_replicas), err_gain=0.2, two=2.0)


def chunk_tensors(rows: np.ndarray, lam: np.ndarray, arrivals: np.ndarray,
                  faults: np.ndarray, device) -> tuple:
    """One chunk's inputs on ``device`` in :func:`run_chunk`'s layout, from
    the host's knob rows ``[W, K]``, rates ``[M, T]`` and arrival and fault
    tables ``[W, M, T]``: ``(knob_rows [W, K], lam_t [T, M], arrivals [T, W,
    M], faults [T, W, M])``, float32 and contiguous."""
    def to_dev(x):
        return torch.from_numpy(np.ascontiguousarray(
            x, dtype=np.float32)).to(device)

    return (to_dev(rows), to_dev(np.asarray(lam, dtype=np.float32).T),
            to_dev(np.asarray(arrivals).transpose(2, 0, 1)),
            to_dev(np.asarray(faults).transpose(2, 0, 1)))


def run_chunk(params: WorldParams, knob_rows, lam_t, arrivals, faults,
              init_replicas: float):
    """Advance one chunk of worlds over the whole horizon on the device of
    ``knob_rows`` (inputs as :func:`run_chunk_plain` takes them): on a CUDA
    device one launch of the scan kernel, which computes the plain
    version's bits; on the CPU the plain version. Returns
    ``(attainment, chip_seconds, wrong_direction, total)``, each ``[W, M]``
    on that device."""
    if knob_rows.device.type == "cpu":
        return run_chunk_plain(params, knob_rows, lam_t, arrivals, faults,
                               init_replicas)
    out = scan_kernel.launch(knob_rows, lam_t, arrivals, faults,
                             scan_constants(params, init_replicas),
                             lead=params.lead_steps)
    return tuple(out)


def run_chunk_plain(params: WorldParams, knob_rows, lam_t, arrivals, faults,
                    init_replicas: float):
    """The scan kernel's plain version: one chunk of worlds over the whole
    horizon on the device of ``knob_rows``: ``knob_rows [W, K]``, ``lam_t
    [T, M]``, ``arrivals`` and ``faults [T, W, M]``, all float32 on one
    device. The counterpart of the reference's ``jit(lax.scan)``: the same
    step, in the same order of float32 operations, looped over T on the
    host. Quantities the step reads but never changes (the knob columns'
    derived operating points) are computed once before the loop; the loop
    makes no host sync. Returns ``(attainment, chip_seconds,
    wrong_direction, total)``, each ``[W, M]`` on the device."""
    p = params
    T, L = p.steps, p.lead_steps
    dev = knob_rows.device
    w, m = int(knob_rows.shape[0]), int(lam_t.shape[1])
    rate_full = replica_rps(p, float(p.max_batch))
    stab_steps = _stab_steps(p)
    c = _Consts(dev, eps=_EPS, zero=0.0, one=1.0, dt=p.dt, two=2.0,
                ms=1000.0, lead=float(L), max_batch=float(p.max_batch),
                max_replicas=float(p.max_replicas), steps=float(T))
    k = {name: knob_rows[:, i:i + 1]
         for i, name in enumerate(kb.KNOB_FIELDS)}

    # Loop-invariant columns [W, 1], each the reference step's expression.
    occ_target = _clip(k["target_utilization"] * p.max_batch, c.one,
                       c.max_batch)
    g_obs = _clip(torch.div(c.dt, torch.maximum(k["grid_step_s"], c.dt)),
                  c.zero, c.one)
    ki_f = k["engine_interval_s"] / c.dt
    ki = _clip(torch.where(torch.isfinite(ki_f), torch.round(ki_f), 1.0),
               c.one, c.steps).to(torch.int32)
    ga, gb = k["level_gain"], k["trend_gain"]
    one_ga, one_gb = 1 - ga, 1 - gb
    lead_intervals = torch.div(c.lead, torch.maximum(
        ki.to(torch.float32), c.one)) + 1.0
    r_target = 1000.0 * occ_target / (
        prefill_ms(p, occ_target)
        + p.avg_output_tokens * iteration_ms(p, occ_target))
    r_target_floor = torch.maximum(r_target, c.eps)
    burst = k["burst_slope_rps"] * p.startup_s

    zero = torch.zeros((w, m), dtype=torch.float32, device=dev)
    q = obs = level = trend = err = evals = zero
    fault_run = recovery = last_lam = attained = total = chip_s = wd = zero
    ready = desired = zero + init_replicas
    since_up = zero + float(stab_steps)
    pipe = torch.zeros((w, m, L), dtype=torch.float32, device=dev)
    pipe_tail = torch.zeros((w, m, 1), dtype=torch.float32, device=dev)

    for t in range(T):
        lam_now, a, f = lam_t[t], arrivals[t], faults[t]

        # Provisioning pipeline head matures into ready replicas.
        ready = ready + pipe[..., 0]
        pipe = torch.cat([pipe[..., 1:], pipe_tail], dim=-1)

        # Serving at full-batch throughput; queue-wait + prefill TTFT.
        cap_rps = ready * rate_full
        wait_s = q / torch.maximum(cap_rps, c.eps)
        occ = _clip((q + a) / torch.maximum(cap_rps * p.dt, c.eps)
                    * p.max_batch, c.one, c.max_batch)
        ttft = wait_s + prefill_ms(p, occ) / c.ms
        ok = (ttft <= p.slo_ttft_s).to(torch.float32)
        backlog = q + a
        served = torch.minimum(backlog, cap_rps * p.dt)
        q_next = backlog - served
        drop = torch.maximum(q_next - p.queue_bound * ready, c.zero)
        q_next = q_next - drop
        attained = attained + torch.maximum(a * ok - drop, c.zero)
        q = q_next
        total = total + a

        # Observation: EWMA of measured rate, stale-held through faults.
        faulted = f > 0
        measured = a / c.dt
        obs = torch.where(faulted, obs, obs + g_obs * (measured - obs))
        fault_run = torch.where(faulted, fault_run + 1.0, 0.0)
        recovery = torch.where(faulted, k["recovery_ticks"],
                               torch.maximum(recovery - 1.0, c.zero))

        # Engine cadence per world.
        act = torch.remainder(t, ki) == 0

        # Holt forecast state, updated at act steps from clean
        # observations; walk-forward trust.
        upd = act & (f <= 0)
        pred_now = level + trend
        sm_err = torch.abs(pred_now - obs) / torch.maximum(
            (torch.abs(pred_now) + torch.abs(obs)) / c.two, c.eps)
        err = torch.where(upd, err + 0.2 * (sm_err - err), err)
        evals = torch.where(upd, evals + 1.0, evals)
        new_level = torch.where(upd, ga * obs + one_ga * (level + trend),
                                level)
        trend = torch.where(upd, gb * (new_level - level) + one_gb * trend,
                            trend)
        level = new_level
        trusted = (evals >= k["min_trust_evals"]) & (err <= k["demote_error"])
        forecast = level + trend * lead_intervals

        # Sizing: cover max(observed + burst insurance, trusted forecast)
        # at the target-occupancy service rate, plus headroom.
        reactive = obs + burst
        target_rate = torch.maximum(reactive,
                                    torch.where(trusted, forecast, 0.0))
        desired_raw = torch.ceil(target_rate / r_target_floor) \
            + k["headroom_replicas"]
        desired_raw = _clip(desired_raw, c.one, c.max_replicas)

        # Health gating + down-stabilization.
        fault_s = fault_run * p.dt
        degraded = fault_s >= k["degraded_after_s"]
        frozen = fault_s >= k["freeze_after_s"]
        can_down = (since_up >= float(stab_steps)) & ~degraded \
            & (recovery <= 0)
        up = desired_raw > desired
        desired_new = torch.where(
            up, desired_raw, torch.where(can_down, desired_raw, desired))
        desired_new = torch.where(frozen, desired, desired_new)
        desired_new = torch.where(act, desired_new, desired)
        wd_event = act & (desired_new < desired) \
            & (lam_now > last_lam + _EPS)
        wd = wd + wd_event.to(torch.float32)
        last_lam = torch.where(act, zero + lam_now, last_lam)
        since_up = torch.where(act & (desired_new > desired), 0.0,
                               since_up + 1.0)
        desired = desired_new

        # Actuation: downs immediate, ups through the pipeline tail.
        # ``pending`` sums the lanes as a left fold in lane order (a
        # reduction kernel picks its own order, and the chunk-width
        # contract needs one that the shape cannot change).
        pending = pipe[..., 0]
        for lane in range(1, L):
            pending = pending + pipe[..., lane]
        excess = torch.maximum(ready - desired, c.zero)
        ready = ready - excess
        short = torch.maximum(desired - (ready + pending), c.zero)
        pipe = torch.cat([pipe[..., :L - 1],
                          (pipe[..., L - 1] + short)[..., None]], dim=-1)

        chip_s = chip_s + desired * p.chips_per_replica * p.dt

    attain = attained / torch.maximum(total, c.one)
    return attain, chip_s, wd, total


def _first_seen(keys) -> tuple[list[int], np.ndarray]:
    """The distinct ``keys`` in first-seen order: the position of each
    one's first appearance, and each key's index among them (so
    ``distinct[inverse]`` gives back one entry a key)."""
    slot: dict = {}
    firsts, inverse = [], []
    for i, key in enumerate(keys):
        if key not in slot:
            slot[key] = len(firsts)
            firsts.append(i)
        inverse.append(slot[key])
    return firsts, np.asarray(inverse, dtype=np.intp)


def run_worlds(params: WorldParams, knob_list, world_seeds, lam: np.ndarray,
               chunk: int = 256, init_replicas: float = 1.0,
               arrivals: np.ndarray | None = None,
               faults: np.ndarray | None = None, device=None) -> dict:
    """Advance ``len(knob_list) == len(world_seeds)`` worlds through the
    whole horizon on ``device`` (None: the CUDA card). Each chunk's knob
    rows and its ``[T, W, M]`` arrival and fault tables go to the device
    once; the horizon's T steps run there in one launch of the scan kernel
    (on the CPU, its plain version), and the dispatch counter is noted once
    per chunk, as the reference notes its one program per chunk.

    The host inputs are built once per distinct key and gathered back to
    one a world: the arrival and fault tables (those not passed in) once
    per distinct seed (``int(seed)``, first-seen order), the knob row and
    degeneracy flag once per distinct knob object (by identity: equality
    would merge a ``-0.0`` point with its ``0.0`` twin). A search's points
    x seeds worlds thus build one table a seed and one row a point, and
    every world gets the bits a build of its own would give.

    Returns per-world arrays: ``attainment [W, M]``,
    ``chip_seconds [W, M]``, ``wrong_direction [W, M]``,
    ``objective [W, M]`` (LOSS_SCORE for NaN/degenerate worlds) and the
    fleet ``score [W]``. Results are bitwise independent of ``chunk``.
    """
    dev = resolve_device(device)
    w_total = len(knob_list)
    assert w_total == len(world_seeds)
    m, t = lam.shape
    assert t == params.steps
    width = max(chunk, 1)
    if arrivals is None or faults is None:
        keys = [int(seed) for seed in world_seeds]
        firsts, inverse = _first_seen(keys)
        distinct = [keys[i] for i in firsts]
        if arrivals is None:
            arrivals = arrivals_table(distinct, lam, params)[inverse]
        if faults is None:
            faults = fault_table(distinct, m, params)[inverse]
    firsts, inverse = _first_seen([id(k) for k in knob_list])
    points = [knob_list[i] for i in firsts]
    rows = np.asarray([kb.to_vector(k) for k in points],
                      dtype=np.float32)[inverse]
    degenerate = np.asarray([kb.is_degenerate(k) for k in points])[inverse]

    outs = {"attainment": [], "chip_seconds": [], "wrong_direction": [],
            "arrivals_total": []}
    for lo in range(0, w_total, width):
        hi = min(lo + width, w_total)
        inputs = chunk_tensors(rows[lo:hi], lam, arrivals[lo:hi],
                               faults[lo:hi], dev)
        parts = run_chunk(params, *inputs, float(init_replicas))
        dispatch.note()  # one launch per chunk x whole horizon
        host = torch.stack(parts).cpu().numpy()  # the one copy
        for key, part in zip(outs, host):
            outs[key].append(part)
    res = {k: np.concatenate(v, axis=0) for k, v in outs.items()}
    res["objective"] = score_objective(params, res, degenerate)
    res["score"] = res["objective"].mean(axis=1)
    res["degenerate"] = degenerate
    return res


def score_objective(params: WorldParams, res: dict,
                    degenerate=None) -> np.ndarray:
    """The bench objective per (world, model): attainment minus
    normalized chip-seconds minus wrong-direction events. Non-finite
    worlds (NaN knobs that flowed through the physics) and host-flagged
    degenerate knob points score LOSS_SCORE — a loss, never a crash."""
    chip_norm = res["chip_seconds"] / max(
        params.chips_per_replica * params.max_replicas * params.horizon_s,
        _EPS)
    obj = (res["attainment"] - params.cost_weight * chip_norm
           - params.wrong_direction_weight * res["wrong_direction"])
    finite = np.isfinite(obj) & np.isfinite(res["attainment"]) \
        & np.isfinite(res["chip_seconds"])
    obj = np.where(finite, obj, LOSS_SCORE)
    if degenerate is not None:
        obj = np.where(degenerate[:, None], LOSS_SCORE, obj)
    return obj.astype(np.float64)


# -- the scalar reference world (baseline + cross-check) -----------------

def run_world_python(params: WorldParams, k, lam: np.ndarray,
                     arrivals: np.ndarray, faults: np.ndarray | None = None,
                     init_replicas: float = 1.0) -> dict:
    """One world, per-step Python loop — the same recurrence the scan
    runs, in scalar float arithmetic. This is the per-world event-loop
    cost model the vectorized throughput is honestly quoted against
    (``chip_smoke.py``), and the cross-check the device program's
    numerics are pinned to (tests)."""
    p = params
    vec = kb.to_vector(k)
    kd = dict(zip(kb.KNOB_FIELDS, vec))
    m_models, t_steps = lam.shape
    L = p.lead_steps
    stab_steps = max(int(round(p.down_stabilization_s / p.dt)), 1)
    rate_full = replica_rps(p, float(p.max_batch))
    occ_target = min(max(kd["target_utilization"] * p.max_batch, 1.0),
                     float(p.max_batch))
    r_target = replica_rps(p, occ_target)
    if faults is None:
        faults = np.zeros_like(lam)

    out = {"attainment": np.zeros(m_models),
           "chip_seconds": np.zeros(m_models),
           "wrong_direction": np.zeros(m_models)}
    for m in range(m_models):
        q = 0.0
        ready = desired = float(init_replicas)
        pipe = [0.0] * L
        obs = level = trend = err = evals = 0.0
        fault_run = recovery = last_lam = 0.0
        since_up = float(stab_steps)
        attained = total = chip_s = wd = 0.0
        ki = int(min(max(round(kd["engine_interval_s"] / p.dt), 1),
                     t_steps)) \
            if math.isfinite(kd["engine_interval_s"]) else 1
        g_obs = min(max(p.dt / max(kd["grid_step_s"], p.dt), 0.0), 1.0)
        for t in range(t_steps):
            lam_t = float(lam[m, t])
            a = float(arrivals[m, t])
            f = float(faults[m, t])
            ready += pipe.pop(0)
            pipe.append(0.0)
            cap_rps = ready * rate_full
            wait_s = q / max(cap_rps, _EPS)
            occ = min(max((q + a) / max(cap_rps * p.dt, _EPS)
                          * p.max_batch, 1.0), float(p.max_batch))
            ttft = wait_s + prefill_ms(p, occ) / 1000.0
            ok = 1.0 if ttft <= p.slo_ttft_s else 0.0
            backlog = q + a
            served = min(backlog, cap_rps * p.dt)
            q = backlog - served
            drop = max(q - p.queue_bound * ready, 0.0)
            q -= drop
            attained += max(a * ok - drop, 0.0)
            total += a
            measured = a / p.dt
            if f <= 0:
                obs = obs + g_obs * (measured - obs)
                fault_run = 0.0
                recovery = max(recovery - 1.0, 0.0)
            else:
                fault_run += 1.0
                recovery = kd["recovery_ticks"]
            act = (t % ki == 0)
            if act and f <= 0:
                pred_now = level + trend
                sm = abs(pred_now - obs) \
                    / max((abs(pred_now) + abs(obs)) / 2.0, _EPS)
                err = err + 0.2 * (sm - err)
                evals += 1.0
                ga, gb = kd["level_gain"], kd["trend_gain"]
                new_level = ga * obs + (1 - ga) * (level + trend)
                trend = gb * (new_level - level) + (1 - gb) * trend
                level = new_level
            trusted = (evals >= kd["min_trust_evals"]
                       and err <= kd["demote_error"])
            forecast = level + trend * (float(L) / max(ki, 1) + 1.0)
            reactive = obs + kd["burst_slope_rps"] * p.startup_s
            target_rate = max(reactive, forecast if trusted else 0.0)
            desired_raw = min(max(
                math.ceil(target_rate / max(r_target, _EPS))
                + kd["headroom_replicas"], 1.0), float(p.max_replicas))
            degraded = fault_run * p.dt >= kd["degraded_after_s"]
            frozen = fault_run * p.dt >= kd["freeze_after_s"]
            can_down = (since_up >= stab_steps and not degraded
                        and recovery <= 0)
            if act:
                if desired_raw > desired:
                    desired_new = desired_raw
                elif can_down:
                    desired_new = desired_raw
                else:
                    desired_new = desired
                if frozen:
                    desired_new = desired
                if desired_new < desired and lam_t > last_lam + _EPS:
                    wd += 1.0
                if desired_new > desired:
                    since_up = 0.0
                else:
                    since_up += 1.0
                last_lam = lam_t
                desired = desired_new
            else:
                since_up += 1.0
            pending = sum(pipe)
            excess = max(ready - desired, 0.0)
            ready -= excess
            short = max(desired - (ready + pending), 0.0)
            pipe[L - 1] += short
            chip_s += desired * p.chips_per_replica * p.dt
        out["attainment"][m] = attained / max(total, 1.0)
        out["chip_seconds"][m] = chip_s
        out["wrong_direction"][m] = wd
    return out
