"""A fleet of models under one Manager, ticked back to back at full width.

Each model has one variant a accelerator (a Deployment, a Pod and a
VariantAutoscaling on a FakeCluster), its telemetry in a TimeSeriesDB on a
FakeClock, SLO classes and profiles through ``update_slo_config``, the SLO
analyzer with forecasting on, and some namespaces routed to the fleet
solve. Before the first tick the TSDB holds ``history_s`` of scrapes and
the planner a demand history; between ticks the clock advances one engine
interval and every pod is scraped afresh.

The traffic file sets the demand: ``moving`` values (each model's demand
in one of four daily shapes with noise, some prompt lengths drifting), so
every model is dirty on every tick, or ``constant`` values (flat gauges, a
request counter rising at a constant rate), so the fingerprint plane
skips clean models between resync passes. The profiles, lengths and
demand levels are drawn from ``--seed``.
"""

from __future__ import annotations

import collections
import contextlib
import math
import time

import numpy as np

from portbench.core import GcClock
from portbench.drivers import probes

T0 = 1_000_000.0
DAY = 86400.0
_MASK64 = (1 << 64) - 1


def _unit(seed: int, t: float) -> float:
    """A uniform number in [0, 1) for (``seed``, whole second ``t``):
    splitmix64."""
    z = (seed * 0x9E3779B97F4A7C15 + int(round(t))) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) / 2.0 ** 64


def fleet(config: dict, traffic: dict, seed: int):
    """Profiles and demand of the fleet: per model, base profile
    parameters (each accelerator at its speed factor), prompt and output
    lengths, a base demand log-uniform in the traffic's range, a shape
    and a phase, and how much demand history is pre-filled."""
    rng = np.random.default_rng(seed % (1 << 63))
    d = traffic["demand"]
    ranges = config["profile_ranges"]
    records, models = [], []
    for m in range(config["n_models"]):
        model_id = f"model-{m:04d}"
        base = {k: rng.uniform(*ranges[k]) for k in ("alpha", "beta", "gamma")}
        variants = []
        for acc, cost, speed in config["accelerators"]:
            records.append(dict(model_id=model_id, accelerator=acc,
                                **{k: v * speed for k, v in base.items()}))
            variants.append(dict(name=f"{model_id}-{acc}", accelerator=acc,
                                 cost=cost))
        h = d["history"]
        models.append(dict(
            model_id=model_id, namespace=f"ns-{m % config['namespaces']}",
            variants=variants,
            avg_in=float(round(rng.uniform(*config["input_tokens"]))),
            avg_out=float(round(rng.uniform(*config["output_tokens"]))),
            base=float(np.exp(rng.uniform(np.log(d["base_rps"][0]),
                                          np.log(d["base_rps"][1])))),
            shape=d["shapes"][m % len(d["shapes"])],
            phase=float(rng.uniform(0, 2 * np.pi)),
            noise_seed=int(rng.integers(1 << 30)),
            drifts=d["drift_every"] > 0 and m % d["drift_every"] == 0,
            history=("none" if m % h["every"] == h["none_at"] else
                     "short" if m % h["every"] == h["short_at"] else
                     "full")))
    return records, models


class Feed:
    """Every pod's telemetry at ``now``: the KV usage and waiting gauges,
    the cache config, the request counter at the pod's share of its
    model's demand, and the prompt and generation token histograms (one
    request a scrape at the model's lengths)."""

    def __init__(self, tsdb, models, traffic, interval):
        self.tsdb, self.models = tsdb, models
        self.d = traffic["demand"]
        self.moving = traffic["values"] == "moving"
        self.interval = interval
        self.first_measured = T0 + traffic["warm_ticks"] * interval
        self.last = None
        self.counters = {}

    def demand(self, md, t):
        if not self.moving:
            return md["base"]
        noise = 1.0 - self.d["noise"] + 2.0 * self.d["noise"] * _unit(
            md["noise_seed"], t)
        wave = math.sin(2 * math.pi * t / DAY + md["phase"])
        shape = {"sine": 1.0 + 0.5 * wave,
                 "ramp": 1.0 + max(t - (T0 - 60.0), 0.0) / 600.0,
                 "growth": (1.0 + 0.5 * wave) * (1.0 + 4.0 * (t - T0 + DAY)
                                                 / DAY),
                 "step": 2.0 if wave > 0 else 1.0}[md["shape"]]
        return md["base"] * shape * noise

    def prompt(self, md, now):
        """A drifting model's prompt length: 1.25x and 1.5x from the
        measured ticks the traffic names."""
        if not (self.moving and md["drifts"]):
            return md["avg_in"]
        tick = round((now - self.first_measured) / self.interval)
        steps = sum(tick >= t for t in self.d["drift_ticks"])
        return md["avg_in"] * (1.0 + 0.25 * steps)

    def __call__(self, now, tokens_only=False):
        dt = 0.0 if self.last is None else now - self.last
        self.last = now
        add = self.tsdb.add_sample
        base = self.d["counter_base"]
        for md in self.models:
            share = self.demand(md, now) / len(md["variants"])
            prompt = self.prompt(md, now)
            for v in md["variants"]:
                pod = {"pod": f"{v['name']}-0", "namespace": md["namespace"],
                       "model_name": md["model_id"]}
                served, n, s_in, s_out = self.counters.get(pod["pod"], (
                    base, base, base * md["avg_in"], base * md["avg_out"]))
                served += share * dt
                n, s_in, s_out = n + 1.0, s_in + prompt, s_out + md["avg_out"]
                self.counters[pod["pod"]] = (served, n, s_in, s_out)
                if not tokens_only:
                    add("vllm:kv_cache_usage_perc", pod, 0.35, timestamp=now)
                    add("vllm:num_requests_waiting", pod, 1, timestamp=now)
                    add("vllm:cache_config_info",
                        {**pod, "num_gpu_blocks": "4096", "block_size": "32"},
                        1.0, timestamp=now)
                    add("vllm:request_success_total", pod, served,
                        timestamp=now)
                add("vllm:request_prompt_tokens_count", pod, n, timestamp=now)
                add("vllm:request_prompt_tokens_sum", pod, s_in,
                    timestamp=now)
                add("vllm:request_generation_tokens_count", pod, n,
                    timestamp=now)
                add("vllm:request_generation_tokens_sum", pod, s_out,
                    timestamp=now)


def prefill(planner, models, feed, interval):
    """The planner's demand history before the first tick: the long
    grid's 2.5 days at half its step, then the fine grid's 160 steps at
    the tick interval (two samples for short histories)."""
    long_step = DAY / 64
    for md in models:
        if md["history"] == "none":
            continue
        if md["history"] == "short":
            ts = [T0 - 2 * interval, T0 - interval]
        else:
            ts = [float(t) for t in np.arange(T0 - 160 * long_step,
                                              T0 - 160 * interval,
                                              long_step / 2)]
            ts += [T0 - (160 - i) * interval for i in range(160)]
        for t in ts:
            planner.observe_demand(md["namespace"], md["model_id"], t,
                                   feed.demand(md, t))


def build(config: dict, traffic: dict, seed: int, device):
    """(manager, clock, feed): the fleet under ``build_manager`` with the
    configuration's levers as shipped."""
    from wva_tpu_torch import api, fused, k8s
    from wva_tpu_torch.analyzers.queueing import (
        PerfProfile,
        ServiceParms,
        TargetPerf,
    )
    from wva_tpu_torch.api.v1alpha1 import CrossVersionObjectReference
    from wva_tpu_torch.collector.source import TimeSeriesDB
    from wva_tpu_torch.config import ForecastConfig, new_test_config
    from wva_tpu_torch.config.slo import ServiceClass, SLOConfigData
    from wva_tpu_torch.engines import common
    from wva_tpu_torch.interfaces import SaturationScalingConfig
    from wva_tpu_torch.main import build_manager
    from wva_tpu_torch.utils.clock import FakeClock

    fused.clear_solve_memo()
    common.DecisionCache.clear()
    while not common.DecisionTrigger.empty():
        common.DecisionTrigger.get_nowait()
    records, models = fleet(config, traffic, seed)
    interval = config["engine_interval_s"]
    clock = FakeClock(T0 - traffic["history_s"])
    cluster = k8s.FakeCluster(clock=clock)
    tsdb = TimeSeriesDB(clock=clock)
    cfg = new_test_config()
    cfg.set_forecast(ForecastConfig(
        enabled=config["forecasting"], grid_step_seconds=interval,
        default_lead_time_seconds=config["lead_s"]))
    for namespace, optimizer in (("", ""), *(
            (ns, "global") for ns in config["global_namespaces"])):
        sat = SaturationScalingConfig(analyzer_name="slo",
                                      optimizer_name=optimizer)
        sat.apply_defaults()
        cfg.update_saturation_config_for_namespace(namespace,
                                                   {"default": sat})
    n_acc = len(config["accelerators"])
    classes, profiles, n_pods = [], [], 0
    for i, md in enumerate(models):
        classes.append(ServiceClass(
            name=f"c-{md['model_id']}", priority=1,
            model_targets={md["model_id"]: TargetPerf(
                target_ttft_ms=config["slo_ttft_ms"],
                target_itl_ms=config["slo_itl_ms"])}))
        for j, v in enumerate(md["variants"]):
            rec = records[i * n_acc + j]
            ns, va = md["namespace"], v["name"]
            profiles.append(PerfProfile(
                model_id=md["model_id"], accelerator=v["accelerator"],
                service_parms=ServiceParms(alpha=rec["alpha"],
                                           beta=rec["beta"],
                                           gamma=rec["gamma"]),
                max_batch_size=config["max_batch_size"],
                max_queue_size=config["max_queue_size"]))
            cluster.create(k8s.Deployment(
                metadata=api.ObjectMeta(name=va, namespace=ns),
                replicas=config["replicas"], selector={"app": va},
                template=k8s.PodTemplateSpec(
                    labels={"app": va},
                    containers=[k8s.Container(
                        name="srv",
                        args=["--max-num-batched-tokens=8192",
                              "--max-num-seqs=256"],
                        resources=k8s.ResourceRequirements(
                            requests={"google.com/tpu": "8"}))]),
                status=k8s.DeploymentStatus(
                    replicas=config["replicas"],
                    ready_replicas=config["replicas"])))
            cluster.create(api.VariantAutoscaling(
                metadata=api.ObjectMeta(
                    name=va, namespace=ns,
                    labels={"inference.optimization/acceleratorName":
                            v["accelerator"]}),
                spec=api.VariantAutoscalingSpec(
                    scale_target_ref=CrossVersionObjectReference(name=va),
                    model_id=md["model_id"], variant_cost=str(v["cost"]))))
            n_pods += 1
            cluster.create(k8s.Pod(
                metadata=api.ObjectMeta(
                    name=f"{va}-0", namespace=ns, labels={"app": va},
                    owner_references=[{"kind": "Deployment", "name": va}]),
                status=k8s.PodStatus(
                    phase="Running", ready=True,
                    pod_ip=f"10.{n_pods // 250}.{n_pods % 250}.{j + 1}")))
    feed = Feed(tsdb, models, traffic, interval)
    while clock.now() < T0:
        feed(clock.now(),
             tokens_only=clock.now() < T0 - traffic["gauge_history_s"])
        clock.advance(interval)
    feed(clock.now())
    mgr = build_manager(cluster, cfg, clock=clock, tsdb=tsdb, device=device)
    mgr.setup()
    mgr.config.update_slo_config(SLOConfigData(service_classes=classes,
                                               profiles=profiles))
    prefill(mgr.engine.forecast, models, feed, interval)
    return mgr, clock, feed


def span_split(tree: dict | None) -> dict:
    """One tick's span tree: ms of each phase, and of every span below
    the phases summed by its path of names (``phase:analyze/model/
    prepare``)."""
    out = collections.Counter()

    def walk(node, path):
        for child in node.get("children", ()):
            here = f"{path}/{child['name']}"
            out[here] += child.get("dur_ms", 0.0)
            walk(child, here)

    for phase in (tree or {}).get("children", ()):
        out[phase["name"]] += phase.get("dur_ms", 0.0)
        walk(phase, phase["name"])
    return dict(out)


class Driver:
    def __init__(self, config, traffic, seed, device, rec):
        self.config, self.traffic, self.rec = config, traffic, rec
        self.interval = config["engine_interval_s"]
        self.patches = probes.Patches()
        probes.fused_program(self.patches, rec)
        probes.kernel_launches(self.patches, rec)
        self.mgr, self.clock, self.feed = build(config, traffic, seed, device)
        self.gc = GcClock()
        engine = self.mgr.engine
        self.phases = probes.PhaseRanges(self.patches, engine)
        probes.decision_stage(self.patches, rec, engine)
        inner = engine.executor.on_tick
        self.outcome = {}

        def on_tick(name, elapsed, ok):
            self.outcome["ok"] = ok
            if inner is not None:
                inner(name, elapsed, ok)

        engine.executor.on_tick = on_tick

    def tick(self):
        """One executor tick on the benchmark's own clock, counted when
        the executor reports its outcome; then the next scrape."""
        engine = self.mgr.engine
        self.outcome.clear()
        t0 = time.perf_counter()
        with probes.labelled("tick"):
            try:
                engine.executor.tick()
            finally:
                self.phases.close()
        t1 = time.perf_counter()
        if self.rec.recording and "ok" in self.outcome:
            tick = {"ms": 1e3 * (t1 - t0), "ok": self.outcome["ok"],
                    "analyzed": engine.last_tick_stats.get("analyzed", 0),
                    "skipped": engine.last_tick_stats.get("skipped", 0)}
            if self.rec.traced:
                tick["spans"] = span_split(self.mgr.spans.last_tree()
                                           if self.mgr.spans else None)
                tick["gc_ms"] = self.gc.ms_within(t0, t1)
            self.rec.ticks.append(tick)
        with probes.labelled("scrape"):
            self.clock.advance(self.interval)
            self.feed(self.clock.now())

    def warm_up(self):
        for _ in range(self.traffic["warm_ticks"]):
            self.tick()

    def window(self, seconds: float):
        deadline = time.perf_counter() + seconds
        with self.gc if self.rec.traced else contextlib.nullcontext():
            while time.perf_counter() < deadline:
                self.tick()

    def end_to_end(self) -> dict:
        from portbench.core import mean

        return {"tick_ms": mean(t["ms"] for t in self.rec.ticks)}

    def counts(self) -> tuple[int, int]:
        ticks = self.rec.ticks
        return len(ticks), sum(not t["ok"] for t in ticks)

    def close(self):
        self.patches.restore()
        self.mgr.shutdown()

