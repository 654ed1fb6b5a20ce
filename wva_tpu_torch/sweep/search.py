"""Massively parallel policy search over the vectorized world.

Three drivers over the typed :class:`~wva_tpu_torch.sweep.knobs.PolicyKnobs`
space — **grid** (exhaustive Cartesian product), **CEM** (cross-entropy:
sample a seeded Gaussian, refit to the elite quantile), and **ES**
(a (mu, lambda) evolution strategy with seeded perturbations) — all
scoring candidates on the existing bench objective (SLO attainment
minus normalized chip-seconds minus wrong-direction events) by batching
every (candidate x train-seed) world into one
:func:`~wva_tpu_torch.sweep.world.run_worlds` call.

**Trust discipline** (the CapacityPlanner backtest rule, applied to
knobs): a tuned candidate is only *recommended* after a walk-forward
pass over held-out seeds it never trained on — evaluated one seed at a
time in order, accumulating an EWMA regret against the incumbent
(shipped defaults). The candidate must clear ``min_evals`` out-of-sample
evaluations AND keep EWMA regret <= ``max_regret`` (mirroring
``WVA_FORECAST_MIN_TRUST_EVALS`` / ``WVA_FORECAST_DEMOTE_ERROR``);
otherwise the recommendation ships ``trusted: false`` with the incumbent
left in place.

Everything is deterministic by construction: all sampling runs on
host-side counter-based generators keyed by
:func:`wva_tpu_torch.utils.seeds.crc_key`, world results are bitwise
independent of the vmap chunk width, and the recommendations JSON is
serialized with sorted keys and fixed rounding — the same sweep at
chunk 1 and chunk 256 writes byte-identical artifacts
(``tests/test_sweep_search.py``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace

import numpy as np

from wva_tpu_torch.sweep import knobs as kb
from wva_tpu_torch.sweep.world import WorldParams, run_worlds
from wva_tpu_torch.utils import seeds as seedmod

# Walk-forward trust gate (the forecast plane's discipline, applied to
# knob recommendations): out-of-sample evals required before a candidate
# may be trusted, EWMA gain on the per-seed regret, and the regret
# ceiling — a candidate that does not beat the incumbent out of sample
# (EWMA regret > max_regret) is demoted to ``trusted: false``.
TRUST_MIN_EVALS = 3
TRUST_EWMA_GAIN = 0.3
TRUST_MAX_REGRET = 0.0


@dataclass(frozen=True)
class SweepResult:
    """One driver run: every evaluated point with its per-model mean
    train score, plus bookkeeping the CLI/bench serialize."""

    points: list          # list[PolicyKnobs], evaluation order
    scores: np.ndarray    # [P, M] mean objective across train seeds
    attainment: np.ndarray  # [P, M] mean attainment across train seeds
    chip_seconds: np.ndarray  # [P, M] mean chip-seconds
    worlds_evaluated: int
    algo: str


def _rng(*key) -> np.random.Generator:
    """Counter-based generator keyed by content — batch composition and
    call order elsewhere can never perturb a draw."""
    return np.random.Generator(np.random.Philox(key=seedmod.crc_key(*key)))


def evaluate_points(params: WorldParams, points, train_seeds, lam,
                    chunk: int = 256, arrivals=None, faults=None,
                    device=None):
    """Score every (point x seed) world in batched dispatches. Returns
    ``(scores [P, M], attain [P, M], chips [P, M], n_worlds)`` where each
    entry is the mean over train seeds (LOSS_SCORE-dominated for
    degenerate points)."""
    n_p, n_s = len(points), len(train_seeds)
    knob_list = [pt for pt in points for _ in train_seeds]
    world_seeds = [s for _ in points for s in train_seeds]
    res = run_worlds(params, knob_list, world_seeds, lam, chunk=chunk,
                     arrivals=arrivals, faults=faults, device=device)
    m = res["objective"].shape[1]
    obj = res["objective"].reshape(n_p, n_s, m)
    att = res["attainment"].reshape(n_p, n_s, m)
    chips = res["chip_seconds"].reshape(n_p, n_s, m)
    return (obj.mean(axis=1), att.mean(axis=1), chips.mean(axis=1),
            n_p * n_s)


def grid_search(params: WorldParams, lam, train_seeds, grid: str = "default",
                base: kb.PolicyKnobs | None = None,
                chunk: int = 256, device=None) -> SweepResult:
    points = kb.grid_points(grid, base)
    scores, att, chips, n = evaluate_points(params, points, train_seeds,
                                            lam, chunk, device=device)
    return SweepResult(points, scores, att, chips, n, "grid")


def cem_search(params: WorldParams, lam, train_seeds, sweep_seed: int = 0,
               generations: int = 4, population: int = 32,
               elite_frac: float = 0.25, chunk: int = 256,
               device=None) -> SweepResult:
    """Cross-entropy method: seeded Gaussian over the knob box, refit
    mean/std to the elite quantile each generation."""
    names = kb.KNOB_FIELDS
    lo = np.array([kb.BOUNDS[n][0] for n in names])
    hi = np.array([kb.BOUNDS[n][1] for n in names])
    mean = np.array(kb.to_vector(kb.DEFAULT_KNOBS))
    std = (hi - lo) / 4.0
    all_points, all_scores, all_att, all_chips = [], [], [], []
    n_worlds = 0
    elite_n = max(int(round(population * elite_frac)), 2)
    for gen in range(generations):
        g = _rng(sweep_seed, "cem", gen)
        raw = mean + std * g.standard_normal((population, len(names)))
        pts = [kb.clip(kb.from_vector(row)) for row in raw]
        scores, att, chips, n = evaluate_points(params, pts, train_seeds,
                                                lam, chunk, device=device)
        n_worlds += n
        all_points += pts
        all_scores.append(scores)
        all_att.append(att)
        all_chips.append(chips)
        fleet = scores.mean(axis=1)
        elite = np.argsort(-fleet, kind="stable")[:elite_n]
        vecs = np.array([kb.to_vector(pts[i]) for i in elite])
        mean = vecs.mean(axis=0)
        std = np.maximum(vecs.std(axis=0), (hi - lo) * 0.02)
    return SweepResult(all_points, np.concatenate(all_scores),
                       np.concatenate(all_att), np.concatenate(all_chips),
                       n_worlds, "cem")


def es_search(params: WorldParams, lam, train_seeds, sweep_seed: int = 0,
              generations: int = 4, population: int = 32,
              sigma_frac: float = 0.1, chunk: int = 256,
              device=None) -> SweepResult:
    """(mu, lambda) evolution strategy: perturb the running best with
    seeded Gaussian noise, keep the generation winner."""
    names = kb.KNOB_FIELDS
    lo = np.array([kb.BOUNDS[n][0] for n in names])
    hi = np.array([kb.BOUNDS[n][1] for n in names])
    sigma = (hi - lo) * sigma_frac
    best_vec = np.array(kb.to_vector(kb.DEFAULT_KNOBS))
    all_points, all_scores, all_att, all_chips = [], [], [], []
    n_worlds = 0
    for gen in range(generations):
        g = _rng(sweep_seed, "es", gen)
        raw = best_vec + sigma * g.standard_normal((population, len(names)))
        pts = [kb.clip(kb.from_vector(row)) for row in raw]
        pts[0] = kb.clip(kb.from_vector(best_vec))  # elitism
        scores, att, chips, n = evaluate_points(params, pts, train_seeds,
                                                lam, chunk, device=device)
        n_worlds += n
        all_points += pts
        all_scores.append(scores)
        all_att.append(att)
        all_chips.append(chips)
        fleet = scores.mean(axis=1)
        best_vec = np.array(kb.to_vector(pts[int(np.argmax(fleet))]))
    return SweepResult(all_points, np.concatenate(all_scores),
                       np.concatenate(all_att), np.concatenate(all_chips),
                       n_worlds, "es")


ALGOS = {"grid": grid_search, "cem": cem_search, "es": es_search}


# -- walk-forward trust gating -------------------------------------------

def walk_forward(params: WorldParams, candidate: kb.PolicyKnobs,
                 incumbent: kb.PolicyKnobs, holdout_seeds, lam,
                 model_idx: int, chunk: int = 256, device=None) -> dict:
    """Walk the candidate forward over ordered held-out seeds it never
    trained on, EWMA-accumulating regret against the incumbent. Both
    policies ride the same seeds (paired comparison). Returns the trust
    verdict + the evidence trail."""
    if not holdout_seeds:
        return {"trusted": False, "evals": 0, "ewma_regret": None,
                "reason": "no holdout seeds"}
    pairs = [candidate, incumbent]
    knob_list = [k for s in holdout_seeds for k in pairs]
    world_seeds = [s for s in holdout_seeds for _ in pairs]
    res = run_worlds(params, knob_list, world_seeds, lam, chunk=chunk,
                     device=device)
    obj = res["objective"][:, model_idx].reshape(len(holdout_seeds), 2)
    ewma = 0.0
    trail = []
    for i, s in enumerate(holdout_seeds):
        regret = float(obj[i, 1] - obj[i, 0])  # incumbent - candidate
        ewma = ewma + TRUST_EWMA_GAIN * (regret - ewma) if i else regret
        trail.append({"seed": int(s), "regret": round(regret, 6),
                      "ewma_regret": round(ewma, 6)})
    evals = len(holdout_seeds)
    trusted = bool(evals >= TRUST_MIN_EVALS and ewma <= TRUST_MAX_REGRET)
    reason = ("ok" if trusted
              else f"evals {evals} < {TRUST_MIN_EVALS}"
              if evals < TRUST_MIN_EVALS
              else f"ewma regret {ewma:.6f} > {TRUST_MAX_REGRET}")
    return {"trusted": trusted, "evals": evals,
            "ewma_regret": round(ewma, 6), "reason": reason,
            "trail": trail}


# -- frontier + recommendations ------------------------------------------

def frontier(result: SweepResult, model_idx: int = 0,
             limit: int = 16) -> list[dict]:
    """Attainment-vs-chip-seconds Pareto frontier across evaluated
    points (degenerate/loss points excluded), cheapest first."""
    rows = []
    for i, pt in enumerate(result.points):
        if result.scores[i, model_idx] <= -1.0e8:
            continue
        rows.append((float(result.chip_seconds[i, model_idx]),
                     float(result.attainment[i, model_idx]), i))
    rows.sort()
    front, best_att = [], -1.0
    for chips, att, i in rows:
        if att > best_att + 1e-12:
            best_att = att
            front.append({
                "chip_seconds": round(chips, 3),
                "attainment": round(att, 6),
                "objective": round(float(result.scores[i, model_idx]), 6),
                "knobs": kb.config_dict(result.points[i]),
            })
    return front[:limit]


def recommend(params: WorldParams, result: SweepResult, holdout_seeds,
              lam, models, chunk: int = 256,
              incumbent: kb.PolicyKnobs | None = None,
              device=None) -> dict:
    """Per-model tuned-knob recommendations: the best train-seed point
    per model, walk-forward trust-gated on holdout seeds. Deterministic
    (sorted keys, fixed rounding) — byte-identical across chunk widths.
    """
    incumbent = incumbent or kb.DEFAULT_KNOBS
    recs = {}
    for m, model in enumerate(models):
        order = np.argsort(-result.scores[:, m], kind="stable")
        best_i = int(order[0])
        cand = result.points[best_i]
        gate = walk_forward(params, cand, incumbent, holdout_seeds, lam,
                            m, chunk=chunk, device=device)
        recs[model] = {
            "knobs": kb.config_dict(cand),
            "train_objective": round(float(result.scores[best_i, m]), 6),
            "train_attainment": round(
                float(result.attainment[best_i, m]), 6),
            "train_chip_seconds": round(
                float(result.chip_seconds[best_i, m]), 3),
            "incumbent_knobs": kb.config_dict(incumbent),
            "trust": gate,
            "applied_knobs": kb.config_dict(
                cand if gate["trusted"] else incumbent),
            "frontier": frontier(result, m),
        }
    return {
        "algo": result.algo,
        "worlds_evaluated": int(result.worlds_evaluated),
        "horizon_s": params.horizon_s,
        "dt_s": params.dt,
        "trust_policy": {"min_evals": TRUST_MIN_EVALS,
                         "ewma_gain": TRUST_EWMA_GAIN,
                         "max_regret": TRUST_MAX_REGRET},
        "recommendations": recs,
    }


def dump_recommendations(report: dict) -> str:
    """Canonical serialization: sorted keys, no float repr drift (all
    floats pre-rounded above)."""
    return json.dumps(report, indent=2, sort_keys=True) + "\n"


def split_seeds(n_train: int, n_holdout: int, sweep_seed: int = 0):
    """Deterministic disjoint train/holdout world-seed sets, derived
    from the sweep seed alone."""
    train = [seedmod.crc_key(sweep_seed, "train", i) & 0x7FFFFFFF
             for i in range(n_train)]
    holdout = [seedmod.crc_key(sweep_seed, "holdout", i) & 0x7FFFFFFF
               for i in range(n_holdout)]
    return train, holdout


def run_sweep(params: WorldParams, lam, models, algo: str = "grid",
              grid: str = "default", n_train: int = 8, n_holdout: int = 4,
              sweep_seed: int = 0, chunk: int = 256,
              generations: int = 4, population: int = 32,
              device=None) -> dict:
    """End-to-end: split seeds, drive the chosen algorithm on train
    seeds, trust-gate the winner on holdout seeds, return the
    recommendations report. ``device`` is where every world runs (None:
    the CUDA card)."""
    train, holdout = split_seeds(n_train, n_holdout, sweep_seed)
    if algo == "grid":
        result = grid_search(params, lam, train, grid=grid, chunk=chunk,
                             device=device)
    elif algo == "cem":
        result = cem_search(params, lam, train, sweep_seed=sweep_seed,
                            generations=generations, population=population,
                            chunk=chunk, device=device)
    elif algo == "es":
        result = es_search(params, lam, train, sweep_seed=sweep_seed,
                           generations=generations, population=population,
                           chunk=chunk, device=device)
    else:
        raise ValueError(f"unknown sweep algo {algo!r}; "
                         f"choose from {sorted(ALGOS)}")
    report = recommend(params, result, holdout, lam, models, chunk=chunk,
                       device=device)
    report["seeds"] = {"sweep_seed": sweep_seed, "train": train,
                       "holdout": holdout}
    report["grid"] = grid if algo == "grid" else None
    return report
