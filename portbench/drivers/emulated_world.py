"""Emulated worlds back to back: one model's variant under a load cycle,
served by the simulator, scaled by the HPA on the Manager's decisions,
with the SLO analyzer, the EKF tuner and the fused program in every
engine tick. World ``i`` of a run draws its arrivals and request sizes
from seed ``--seed + i``.

The configuration states the deployment (the model's true latency law,
its profile, SLO, actuation and engine cadence); the traffic file the
load cycle, the request-size mixture, the warm-up and what is compared.
"""

from __future__ import annotations

import os
import time

from portbench.drivers import probes
from portbench.worlds.harness import EmulationHarness, VariantSpec
from portbench.worlds.hpa import HPAParams
from portbench.worlds.loadgen import trapezoid
from portbench.worlds.server_sim import ServingParams

SEED_SPACE = 1 << 63


def world_seconds(load: dict) -> float:
    return (load["delay_s"] + load["ramp_up_s"] + load["hold_s"]
            + load["ramp_down_s"] + load["tail_s"])


def build(config: dict, traffic: dict, seed: int, device):
    """One world's harness, its engine on ``device``."""
    from wva_tpu_torch import fused
    from wva_tpu_torch.analyzers.queueing.params import (
        PerfProfile,
        ServiceParms,
        TargetPerf,
    )
    from wva_tpu_torch.config import new_test_config
    from wva_tpu_torch.config.slo import ServiceClass, SLOConfigData
    from wva_tpu_torch.engines import common
    from wva_tpu_torch.interfaces import SaturationScalingConfig

    fused.clear_solve_memo()
    common.DecisionCache.clear()
    while not common.DecisionTrigger.empty():
        common.DecisionTrigger.get_nowait()
    load, true = traffic["load"], config["latency_parms_ms"]
    model = config["model_id"]
    sat = SaturationScalingConfig(
        analyzer_name="slo",
        anticipation_horizon_seconds=config["startup_s"]
        + config["anticipation_margin_s"],
        # The declared worst-credible ramp: half the cycle's true slope.
        burst_slope_rps=(load["peak_rps"] - load["base_rps"])
        / load["ramp_up_s"] / 2.0,
        headroom_replicas=config["headroom_replicas"],
        enable_limiter=config["limiter"],
        fast_actuation=config["fast_actuation"])
    sat.apply_defaults()
    variant = VariantSpec(
        name=config["variant"], model_id=model,
        accelerator=config["accelerator"],
        chips_per_replica=config["chips_per_replica"], cost=config["cost"],
        initial_replicas=config["initial_replicas"],
        serving=ServingParams(
            engine=config["serving_engine"],
            token_mixture=tuple(tuple(c) for c in traffic["token_mixture"]),
            latency_parms=tuple(true)),
        load=trapezoid(load["base_rps"], load["peak_rps"], load["ramp_up_s"],
                       load["hold_s"], load["ramp_down_s"],
                       tail=load["tail_s"], delay=load["delay_s"]),
        hpa=HPAParams(**config["hpa"]))
    # The arrival-rate window is read when the harness registers its
    # queries.
    os.environ["WVA_SLO_ARRIVAL_RATE_WINDOW"] = config["arrival_rate_window"]
    try:
        harness = EmulationHarness(
            [variant], saturation_config=sat, config=new_test_config(),
            nodepools=[tuple(p) for p in config["nodepools"]],
            startup_seconds=config["startup_s"],
            engine_interval=config["engine_interval_s"],
            stochastic_seed=seed % SEED_SPACE, device=device)
    finally:
        os.environ.pop("WVA_SLO_ARRIVAL_RATE_WINDOW", None)
    off = config["profile_miscalibration"]
    harness.config.update_slo_config(SLOConfigData(
        service_classes=[ServiceClass(
            name=config["service_class"], priority=1,
            model_targets={model: TargetPerf(
                target_ttft_ms=config["slo_ttft_ms"])})],
        profiles=[PerfProfile(
            model_id=model, accelerator=config["accelerator"],
            service_parms=ServiceParms(alpha=true[0] * off,
                                       beta=true[1] * off,
                                       gamma=true[2] * off),
            max_batch_size=config["max_batch_size"],
            max_queue_size=config["max_queue_size"])],
        tuner_enabled=config["tuner_enabled"]))
    return harness


class World:
    """One world in progress: its harness, the tick observer chained onto
    the engine's executor, and the outcome bench.py reports (from the
    load cycle's onset)."""

    def __init__(self, config, traffic, seed, device, rec):
        self.config, self.rec = config, rec
        self.h = build(config, traffic, seed, device)
        self.seconds = world_seconds(traffic["load"])
        self.onset = traffic["load"]["delay_s"]
        self.t = 0.0
        self.peak, self.chip_seconds, self.last = 1, 0.0, None
        engine = self.h.manager.engine
        inner_tick = engine.executor.on_tick
        outcome = {}

        def on_tick(name, elapsed, ok):
            outcome["ok"] = ok
            if inner_tick is not None:
                inner_tick(name, elapsed, ok)

        engine.executor.on_tick = on_tick
        tick = engine.executor.tick
        self.patches = probes.Patches()
        phases = probes.PhaseRanges(self.patches, engine)
        probes.decision_stage(self.patches, rec, engine)

        def labelled_tick(*args, **kwargs):
            # The whole executor tick on the benchmark's own clock; a tick
            # counts when the executor reports its outcome (a tick its
            # gate skips, or one aborted, does not).
            outcome.clear()
            t0 = time.perf_counter()
            with probes.labelled("tick"):
                try:
                    return tick(*args, **kwargs)
                finally:
                    phases.close()
                    t1 = time.perf_counter()
                    if rec.recording and "ok" in outcome:
                        rec.ticks.append({"ms": 1e3 * (t1 - t0),
                                          "ok": outcome["ok"]})

        engine.executor.tick = labelled_tick
        observe = engine.slo_tuner.observe

        def timed_observe(*args, **kwargs):
            t0 = time.perf_counter()
            with probes.labelled("tuner step"):
                out = observe(*args, **kwargs)
            if rec.recording and out is not None:
                rec.timers["tuner_step"].append(
                    1e3 * (time.perf_counter() - t0))
            return out

        engine.slo_tuner.observe = timed_observe

    def watch(self, h, t):
        reps = h.replicas_of(self.config["variant"])
        self.peak = max(self.peak, reps)
        if t >= self.onset:
            dt = t - self.last if self.last is not None else 0.0
            self.chip_seconds += reps * self.config["chips_per_replica"] * dt
        self.last = t

    def step(self):
        with probes.labelled("world step"):
            self.h.step(1.0, on_step=self.watch)
        self.t += 1.0

    @property
    def done(self) -> bool:
        return self.t >= self.seconds

    def outcome(self) -> dict:
        sim = self.h.sim_of_model(self.config["model_id"])
        return {"slo_attainment": sim.slo_attainment(
                    self.config["slo_ttft_ms"] / 1000.0,
                    since=self.h.start_time + self.onset),
                "peak_slices": self.peak,
                "slices_at_end": self.h.replicas_of(self.config["variant"]),
                "chip_seconds": int(self.chip_seconds)}

    def close(self):
        self.patches.restore()
        self.h.manager.shutdown()


class Driver:
    def __init__(self, config, traffic, seed, device, rec):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.rec = seed, device, rec
        self.patches = probes.Patches()
        probes.fused_program(self.patches, rec, timer="fused")
        probes.tuner_observation(self.patches, rec)
        probes.kernel_launches(self.patches, rec)
        self.worlds = 0

    def warm_up(self):
        """The first ``warmup_s`` emulated seconds of world 0, unrecorded:
        every kernel the ticks launch is built, loaded and run."""
        world = World(self.config, self.traffic, self.seed, self.device,
                      self.rec)
        try:
            while world.t < self.traffic["warmup_s"]:
                world.step()
        finally:
            world.close()

    def window(self, seconds: float):
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline:
            world = World(self.config, self.traffic, self.seed + self.worlds,
                          self.device, self.rec)
            self.worlds += 1
            try:
                while not world.done and time.perf_counter() < deadline:
                    world.step()
            finally:
                world.close()

    def run_world(self, seed: int) -> dict:
        """One whole world, unrecorded: its outcome."""
        world = World(self.config, self.traffic, seed, self.device, self.rec)
        try:
            while not world.done:
                world.step()
            return world.outcome()
        finally:
            world.close()

    def end_to_end(self) -> dict:
        from portbench.core import mean, percentile

        ms = [t["ms"] for t in self.rec.ticks]
        return {"tick_ms": mean(ms), "tick_p95_ms": percentile(ms, 95.0)}

    def counts(self) -> tuple[int, int]:
        ticks = self.rec.ticks
        return len(ticks), sum(not t["ok"] for t in ticks)

    def close(self):
        self.patches.restore()
