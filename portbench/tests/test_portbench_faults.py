"""Runs driven with the timed path broken underneath, on the CPU (the
look for a card skipped, every other part of a run as it is): each fault
a cell can have must turn ``correct`` false."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.tests import small


def run_cell(workload, seconds=3):
    with small.cells():
        args = run.parse(["--workload", workload, "--seed", "2900000017",
                          "--seconds", str(seconds), "--trace", "0"])
        return run.run(args, device="cpu")


def scaled(fn, key, factor):
    def inner(*args, **kwargs):
        out = fn(*args, **kwargs)
        out[key] = out[key] * factor
        return out
    return inner


def sizing_altered(mp):
    from wva_tpu_torch.fused import program

    mp.setattr(program, "size_batch",
               scaled(program.size_batch, "max_rate_per_s", 1.01))


def half_the_batch_left_out(mp):
    """The second half of every sizing batch never computed (left at 0)."""
    from wva_tpu_torch.fused import program

    inner = program.size_batch

    def size_batch(cand, *args, **kwargs):
        out = inner(cand, *args, **kwargs)
        half = cand.alpha.shape[0] // 2
        return {k: torch.cat([v[:half], torch.zeros_like(v[half:])])
                for k, v in out.items()}

    mp.setattr(program, "size_batch", size_batch)


def fits_altered(mp):
    from wva_tpu_torch.fused import program

    inner = program._fits
    mp.setattr(program, "_fits", lambda *a, **k: inner(*a, **k) * 1.01)


def jacobian_altered(mp):
    from wva_tpu_torch.analyzers.queueing import tuner

    inner = tuner.observe_and_jacobian_plain

    def observe(x, env):
        h, jac = inner(x, env)
        return h, jac * 1.01

    mp.setattr(tuner, "observe_and_jacobian_plain", observe)


def observation_altered(mp):
    from wva_tpu_torch.analyzers.queueing import tuner

    inner = tuner.observe_and_jacobian_plain

    def observe(x, env):
        h, jac = inner(x, env)
        return h * 1.01, jac

    mp.setattr(tuner, "observe_and_jacobian_plain", observe)


def scan_state_unchanged(mp):
    """The chunk's worlds returned as they started: nothing stepped."""
    from wva_tpu_torch.sweep import world

    def run_chunk_plain(params, knob_rows, lam_t, arrivals, *args):
        zero = torch.zeros((knob_rows.shape[0], lam_t.shape[1]))
        return zero, zero, zero, arrivals.sum(dim=0)

    mp.setattr(world, "run_chunk_plain", run_chunk_plain)


def scan_answer_altered(mp):
    from wva_tpu_torch.sweep import world

    inner = world.run_chunk_plain

    def run_chunk_plain(*args):
        attain, chips, wd, total = inner(*args)
        return attain, chips * 1.01, wd, total

    mp.setattr(world, "run_chunk_plain", run_chunk_plain)


def decision_altered(mp):
    """Every cost-aware decision one replica above what the optimizer
    worked out, where the decisions are produced."""
    from wva_tpu_torch.pipeline import vectorized

    inner = vectorized.cost_aware_fleet

    def cost_aware_fleet(*args, **kwargs):
        out = inner(*args, **kwargs)
        for d in out:
            d.target_replicas += 1
        return out

    mp.setattr(vectorized, "cost_aware_fleet", cost_aware_fleet)


def allocation_altered(mp):
    """Every placement the fleet solve chooses from one replica larger."""
    from wva_tpu_torch.fleet import solver

    inner = solver.build_candidates

    def build_candidates(*args, **kwargs):
        out = inner(*args, **kwargs)
        for allocations in out.values():
            for a in allocations:
                a.num_replicas += 1
        return out

    mp.setattr(solver, "build_candidates", build_candidates)


def request_size_altered(mp):
    """Every model's candidate rows built with prompts 1% longer than the
    collected telemetry says."""
    from wva_tpu_torch.analyzers.queueing import analyzer

    inner = analyzer.QueueingModelAnalyzer._observed_request_size

    def observed(self, input):
        size = inner(self, input)
        size.avg_input_tokens *= 1.01
        return size

    mp.setattr(analyzer.QueueingModelAnalyzer, "_observed_request_size",
               observed)


def limiter_grants_nothing(mp):
    """The slice limiter holds every scale-up at the current replicas."""
    from wva_tpu_torch.pipeline import limiter

    def allocate(self, decisions, allocator):
        for d in decisions:
            d.target_replicas = min(d.target_replicas, d.current_replicas)

    mp.setattr(limiter.GreedyBySaturation, "allocate", allocate)


FAULTS = [
    ("mixtral-8x7b-v5e8.ramp", sizing_altered, "rate_gap"),
    ("mixtral-8x7b-v5e8.ramp", fits_altered, "fit_gap"),
    ("mixtral-8x7b-v5e8.ramp", jacobian_altered, "jac_gap"),
    ("mixtral-8x7b-v5e8.ramp", observation_altered, "h_gap"),
    ("fleet-1000x2.busy", half_the_batch_left_out, "rate_gap"),
    ("fleet-1000x2.busy", sizing_altered, "rate_gap"),
    ("fleet-1000x2.busy", fits_altered, "fit_gap"),
    ("mixtral-8x7b-v5e8.ramp", decision_altered, "decision_gap"),
    ("mixtral-8x7b-v5e8.ramp", limiter_grants_nothing, "decision_gap"),
    ("fleet-1000x2.busy", decision_altered, "decision_gap"),
    ("fleet-1000x2.busy", allocation_altered, "decision_gap"),
    ("fleet-1000x2.busy", request_size_altered, "decision_gap"),
    ("mixtral-8x7b-v5e8.retune", scan_state_unchanged, "scan_gap"),
    ("mixtral-8x7b-v5e8.retune", scan_answer_altered, "scan_gap"),
]


@pytest.mark.parametrize("workload,fault,number", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f, _ in FAULTS])
def test_fault_turns_correct_false(monkeypatch, workload, fault, number):
    fault(monkeypatch)
    result = run_cell(workload)
    assert result["correct"] is False
    got = result["compared"][number]
    assert got["value"] > got["limit"], got


@pytest.mark.parametrize("workload", ["mixtral-8x7b-v5e8.ramp",
                                      "fleet-1000x2.busy",
                                      "mixtral-8x7b-v5e8.retune"])
def test_sound_run_is_correct(workload):
    result = run_cell(workload)
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
