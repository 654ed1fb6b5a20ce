# A frozen copy of wva_tpu_torch/emulator/server_sim.py (imports of its siblings
# pointed here), so that the benchmark's world cannot move with the program.
"""Inference-serving simulator
(equivalent of llm-d-inference-sim, ``test/utils/resources/llmdsim.go:16-60``:
configurable TTFT/ITL/KV-size fake server emitting genuine metric names).

A fluid+request hybrid model per replica:
- requests wait in a per-replica admission queue (``num_requests_waiting`` /
  ``jetstream_prefill_backlog_size``);
- admitted requests occupy a decode slot; each slot decodes at ``1/itl``
  tokens/s; prefill costs ``ttft_base + in_tokens/prefill_rate``;
- KV usage = sum of (in_tokens + generated) across active requests divided by
  the replica's KV token capacity;
- a model-level scheduler queue (flow-control) holds requests while every
  ready replica's queue is at its bound — with zero ready replicas everything
  lands there, which is what scale-from-zero watches.

Per-request TTFT (scheduler wait + admission wait + prefill) is recorded for
SLO-attainment measurement. Metric emission pushes samples into the in-memory
TSDB under either the ``vllm:*`` or ``jetstream_*`` family.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from wva_tpu_torch.collector.source.promql import TimeSeriesDB


@dataclass
class ServingParams:
    engine: str = "jetstream"  # "jetstream" | "vllm"
    max_concurrent_decodes: int = 96  # decode slots (vLLM: max_num_seqs)
    tokens_per_slot: int = 1365  # KV budget per slot (vLLM: blocks*block_size/S)
    avg_input_tokens: float = 512.0
    avg_output_tokens: float = 256.0
    ttft_base_seconds: float = 0.2  # prefill launch overhead (sim default
    # mirrors llm-d-inference-sim --time-to-first-token 200ms)
    prefill_tokens_per_second: float = 8000.0
    itl_seconds: float = 0.02  # per-token decode latency (sim default 20ms)
    queue_bound: int = 64  # per-replica admission queue bound
    # vLLM metric family details
    num_kv_blocks: int = 8192
    block_size: int = 16
    # Request-size mixture for STOCHASTIC runs: ((weight, in, out), ...)
    # components; each arrival draws one component (seeded — see
    # ``ModelServerSim(seed=...)``). None = every request is the avg_* point
    # values. Deterministic runs ignore the mixture (no RNG to draw with).
    token_mixture: tuple = None
    # Batch-aware latency physics: (alpha_ms, beta_ms, gamma_ms) of the
    # iteration-time law T(n) = alpha + n*(beta*tc + gamma*tm) — the same
    # law the SLO analyzer's queueing model and the reference's fitted
    # profiles use (queueanalyzer.go:261-280). When set, prefill and
    # per-token decode latency grow with the CURRENT batch occupancy
    # (real continuous-batching behavior: more concurrent sequences ->
    # slower iterations), and ttft_base/prefill_rate/itl_seconds above are
    # ignored. None keeps the legacy fixed-latency fluid model.
    latency_parms: tuple = None

    @property
    def kv_capacity_tokens(self) -> int:
        if self.engine == "vllm":
            return self.num_kv_blocks * self.block_size
        return self.max_concurrent_decodes * self.tokens_per_slot


@dataclass
class _Request:
    arrived_at: float
    in_tokens: float
    out_tokens: float
    admitted_at: float = -1.0
    prefill_done_at: float = -1.0
    generated: float = 0.0
    first_token_at: float = -1.0
    decode_seconds: float = 0.0  # accumulated decode wall time (TPOT telemetry)


@dataclass
class _ReplicaState:
    name: str
    params: "ServingParams" = None
    queue: list[_Request] = field(default_factory=list)
    active: list[_Request] = field(default_factory=list)
    success_total: float = 0.0
    prompt_tokens_sum: float = 0.0
    prompt_tokens_count: float = 0.0
    gen_tokens_sum: float = 0.0
    gen_tokens_count: float = 0.0
    ttft_sum: float = 0.0
    ttft_count: float = 0.0
    tpot_sum: float = 0.0
    tpot_count: float = 0.0


class ModelServerSim:
    """Simulates ALL replicas of one model — across every variant, since the
    EPP routes a model's traffic over all its pods. Each replica carries its
    own ServingParams (heterogeneous variants: v5e vs v5p capacity)."""

    def __init__(self, model_id: str, namespace: str, params: ServingParams,
                 tsdb: TimeSeriesDB, seed: int | None = None) -> None:
        self.model_id = model_id
        self.namespace = namespace
        self.params = params  # model-level workload defaults (arrivals shape)
        self.tsdb = tsdb
        # seed != None switches arrivals to a seeded Poisson process and
        # request sizes to the params.token_mixture draw — the stochastic
        # regime real traffic lives in (guidellm-style generators produce
        # bursty instantaneous rates even at a "constant" target, reference
        # test/utils/e2eutils.go:598-621). Seeded -> reproducible.
        self._rng = None if seed is None else np.random.default_rng(seed)
        # Normalized mixture weights, precomputed once: _draw_request_size
        # runs per ARRIVAL (hundreds of thousands per bench run).
        self._mixture_p = None
        if params.token_mixture:
            w = np.asarray([c[0] for c in params.token_mixture], np.float64)
            self._mixture_p = w / w.sum()
        self._replicas: dict[str, _ReplicaState] = {}
        self.scheduler_queue: list[_Request] = []
        self._arrival_carry = 0.0
        # (arrival time, ttft): keyed by ARRIVAL so phase-split windows
        # attribute a request to the phase that produced its latency —
        # a ramp-era request first served minutes later is a ramp miss,
        # not a steady-state one.
        self.ttft_samples: list[tuple[float, float]] = []
        self.rejected_requests = 0
        # Completions across the sim's LIFETIME — per-replica success_total
        # vanishes with the replica on scale-down (Prometheus staleness),
        # so "requests served" measured from live replicas undercounts any
        # run that ever scales down.
        self.completed_total = 0

    # --- replica lifecycle (driven by the fake kubelet) ---

    def set_ready_replicas(self, pods: "list[str] | dict[str, ServingParams]") -> None:
        """``pods``: pod names (uniform params) or pod -> ServingParams."""
        if isinstance(pods, dict):
            wanted = dict(pods)
        else:
            wanted = {name: self.params for name in pods}
        existing = set(self._replicas)
        for name in set(wanted) - existing:
            self._replicas[name] = _ReplicaState(name=name, params=wanted[name])
        for name in existing - set(wanted):
            # Pod deleted: its queued/active requests go back to the scheduler
            # queue; its series disappear (Prometheus staleness).
            state = self._replicas.pop(name)
            self.scheduler_queue.extend(state.queue)
            self.scheduler_queue.extend(state.active)
            self._drop_series(name)

    # --- simulation step ---

    def step(self, now: float, dt: float, arrival_rate: float) -> None:
        """Advance the world by dt seconds with the given request arrival
        rate (requests/second)."""
        p = self.params
        # 1. arrivals -> scheduler queue. Deterministic mode integerizes
        # rate*dt with a carry; stochastic mode draws Poisson(rate*dt) —
        # instantaneous-rate excursions (the thing burst headroom exists to
        # absorb) only exist in the stochastic regime.
        if self._rng is None:
            self._arrival_carry += arrival_rate * dt
            n_new = int(self._arrival_carry)
            self._arrival_carry -= n_new
        else:
            n_new = int(self._rng.poisson(arrival_rate * dt))
        for _ in range(n_new):
            in_tok, out_tok = self._draw_request_size()
            self.scheduler_queue.append(_Request(
                arrived_at=now, in_tokens=in_tok, out_tokens=out_tok))

        replicas = sorted(self._replicas.values(), key=lambda r: r.name)

        # 2. route scheduler queue to least-loaded replica queues.
        if replicas:
            while self.scheduler_queue:
                target = min(replicas,
                             key=lambda r: (len(r.queue) + len(r.active))
                             / max(r.params.max_concurrent_decodes, 1))
                if len(target.queue) >= target.params.queue_bound:
                    break
                target.queue.append(self.scheduler_queue.pop(0))

        # 3. per-replica: admit, prefill, decode, complete.
        for r in replicas:
            self._step_replica(r, now, dt)

    def _draw_request_size(self) -> tuple[float, float]:
        """(in_tokens, out_tokens) for one arrival: a seeded draw from the
        params' token mixture in stochastic mode, else the point averages."""
        p = self.params
        if self._rng is None or self._mixture_p is None:
            return p.avg_input_tokens, p.avg_output_tokens
        idx = int(self._rng.choice(len(self._mixture_p), p=self._mixture_p))
        _, in_tok, out_tok = p.token_mixture[idx]
        return float(in_tok), float(out_tok)

    @staticmethod
    def _iteration_seconds(p: ServingParams, batch: int,
                           active: "list[_Request]") -> float:
        """T(n)/1000 for the batch-aware latency mode: alpha + n*(beta*tc +
        gamma*tm) ms, with token factors from the ACTUAL active set (the
        queueing model uses fleet averages; the physics uses what is really
        batched together)."""
        a, b, g = p.latency_parms
        if active:
            mean_in = sum(q.in_tokens for q in active) / len(active)
            mean_out = sum(q.out_tokens for q in active) / len(active)
        else:
            mean_in, mean_out = p.avg_input_tokens, p.avg_output_tokens
        tc = (mean_in + mean_out) / (mean_out + 1.0)
        tm = mean_in + mean_out / 2.0
        return (a + batch * (b * tc + g * tm)) / 1000.0

    def _step_replica(self, r: _ReplicaState, now: float, dt: float) -> None:
        p = r.params
        batch_aware = p.latency_parms is not None
        # admit while decode slots free
        while r.queue and len(r.active) < p.max_concurrent_decodes:
            req = r.queue.pop(0)
            req.admitted_at = now
            if batch_aware:
                # prefill(n) = T(n) + (beta+gamma)*in_tokens ms at the
                # occupancy the request joins (queueanalyzer.go:269-274).
                _, b, g = p.latency_parms
                t_n = self._iteration_seconds(p, len(r.active) + 1, r.active)
                prefill_time = t_n + (b + g) * req.in_tokens / 1000.0
            else:
                prefill_time = (p.ttft_base_seconds
                                + req.in_tokens / p.prefill_tokens_per_second)
            req.prefill_done_at = now + prefill_time
            r.active.append(req)

        # decode: each active request past prefill generates dt/itl tokens;
        # in batch-aware mode itl grows with the replica's occupancy
        # (itl(n) = T(n) + beta + gamma*(in + out/2), queueanalyzer.go:277).
        if batch_aware:
            _, b, g = p.latency_parms
            t_n = self._iteration_seconds(p, len(r.active), r.active)
        completed = []
        for req in r.active:
            if now + dt < req.prefill_done_at:
                continue
            if batch_aware:
                itl = t_n + (b + g * (req.in_tokens + req.out_tokens / 2.0)) / 1000.0
            else:
                itl = p.itl_seconds
            if req.first_token_at < 0:
                # Batch-aware mode: the first token lands one decode
                # iteration after prefill (matching the queueing model's
                # TTFT = wait + prefill + itl, queueanalyzer.go:148 — the
                # EKF tuner compares this exact observable against its
                # prediction, so the definitions must agree).
                req.first_token_at = max(req.prefill_done_at, now) + (
                    itl if batch_aware else 0.0)
                ttft = req.first_token_at - req.arrived_at
                r.ttft_sum += ttft
                r.ttft_count += 1
                self.ttft_samples.append((req.arrived_at, ttft))
            decode_window = min(dt, max(now + dt - req.prefill_done_at, 0.0))
            effective = decode_window / itl
            req.generated += effective
            req.decode_seconds += effective * itl
            if req.generated >= req.out_tokens:
                completed.append(req)

        for req in completed:
            r.active.remove(req)
            r.success_total += 1
            self.completed_total += 1
            r.prompt_tokens_sum += req.in_tokens
            r.prompt_tokens_count += 1
            r.gen_tokens_sum += req.out_tokens
            r.gen_tokens_count += 1
            r.tpot_sum += req.decode_seconds
            r.tpot_count += req.generated

    # --- metric emission ---

    def emit_metrics(self, now: float) -> None:
        for r in sorted(self._replicas.values(), key=lambda x: x.name):
            p = r.params
            labels = {"pod": r.name, "namespace": self.namespace,
                      "model_name": self.model_id}
            kv_tokens = sum(req.in_tokens + req.generated for req in r.active)
            kv_usage = min(kv_tokens / p.kv_capacity_tokens, 1.0) \
                if p.kv_capacity_tokens else 0.0
            slots_used = len(r.active)

            if p.engine == "vllm":
                add = self.tsdb.add_sample
                add("vllm:kv_cache_usage_perc", labels, kv_usage, now)
                add("vllm:num_requests_waiting", labels, len(r.queue), now)
                add("vllm:num_requests_running", labels, slots_used, now)
                add("vllm:cache_config_info",
                    {**labels, "num_gpu_blocks": str(p.num_kv_blocks),
                     "block_size": str(p.block_size)}, 1.0, now)
                add("vllm:request_success_total", labels, r.success_total, now)
                add("vllm:request_prompt_tokens_sum", labels, r.prompt_tokens_sum, now)
                add("vllm:request_prompt_tokens_count", labels, r.prompt_tokens_count, now)
                add("vllm:request_generation_tokens_sum", labels, r.gen_tokens_sum, now)
                add("vllm:request_generation_tokens_count", labels, r.gen_tokens_count, now)
                add("vllm:time_to_first_token_seconds_sum", labels, r.ttft_sum, now)
                add("vllm:time_to_first_token_seconds_count", labels, r.ttft_count, now)
                add("vllm:time_per_output_token_seconds_sum", labels, r.tpot_sum, now)
                add("vllm:time_per_output_token_seconds_count", labels, r.tpot_count, now)
            else:
                add = self.tsdb.add_sample
                add("jetstream_kv_cache_utilization", labels, kv_usage, now)
                add("jetstream_prefill_backlog_size", labels, len(r.queue), now)
                add("jetstream_generate_backlog_size", labels, 0, now)
                add("jetstream_slots_used", labels, slots_used, now)
                add("jetstream_slots_available", labels,
                    p.max_concurrent_decodes - slots_used, now)
                add("jetstream_serving_config_info",
                    {**labels,
                     "max_concurrent_decodes": str(p.max_concurrent_decodes),
                     "tokens_per_slot": str(p.tokens_per_slot),
                     "max_target_length": str(int(p.avg_input_tokens
                                                  + p.avg_output_tokens))}, 1.0, now)
                add("jetstream_request_success_total", labels, r.success_total, now)
                add("jetstream_request_input_length_sum", labels, r.prompt_tokens_sum, now)
                add("jetstream_request_input_length_count", labels, r.prompt_tokens_count, now)
                add("jetstream_request_output_length_sum", labels, r.gen_tokens_sum, now)
                add("jetstream_request_output_length_count", labels, r.gen_tokens_count, now)
                add("jetstream_time_to_first_token_seconds_sum", labels, r.ttft_sum, now)
                add("jetstream_time_to_first_token_seconds_count", labels, r.ttft_count, now)
                add("jetstream_time_per_output_token_seconds_sum", labels, r.tpot_sum, now)
                add("jetstream_time_per_output_token_seconds_count", labels, r.tpot_count, now)

        # model-level scheduler flow control
        self.tsdb.add_sample("inference_extension_flow_control_queue_size",
                             {"target_model_name": self.model_id},
                             len(self.scheduler_queue), now)
        self.tsdb.add_sample("inference_extension_flow_control_queue_bytes",
                             {"target_model_name": self.model_id},
                             len(self.scheduler_queue)
                             * self.params.avg_input_tokens * 4, now)

    def epp_exposition(self) -> str:
        """Prometheus text for the EPP pod scrape (scale-from-zero path)."""
        size = len(self.scheduler_queue)
        byte_count = size * self.params.avg_input_tokens * 4
        return (
            f'inference_extension_flow_control_queue_size'
            f'{{target_model_name="{self.model_id}"}} {size}\n'
            f'inference_extension_flow_control_queue_bytes'
            f'{{target_model_name="{self.model_id}"}} {byte_count}\n'
        )

    def _drop_series(self, pod_name: str) -> None:
        labels = {"pod": pod_name, "namespace": self.namespace,
                  "model_name": self.model_id}
        for name in ("vllm:kv_cache_usage_perc", "vllm:num_requests_waiting",
                     "jetstream_kv_cache_utilization",
                     "jetstream_prefill_backlog_size",
                     "jetstream_slots_used", "jetstream_slots_available"):
            self.tsdb.drop_series(name, labels)

    # --- measurement helpers ---

    def _unserved_requests(self) -> list[_Request]:
        """Requests that arrived but have no first token yet (scheduler queue,
        admission queues, and admitted-but-prefilling)."""
        out = list(self.scheduler_queue)
        for r in self._replicas.values():
            out.extend(r.queue)
            out.extend(req for req in r.active if req.first_token_at < 0)
        return out

    def ttft_percentile(self, pct: float, since: float = 0.0,
                        now: float | None = None,
                        until: float | None = None) -> float:
        """Percentile over served TTFTs, counting still-unserved requests at
        their current (lower-bound) age so under-scaling can't hide its worst
        tail by never serving it. ``until`` bounds the arrival window (for
        ramp-phase vs steady-state splits)."""
        end = float("inf") if until is None else until
        samples = [t for ts, t in self.ttft_samples if since <= ts < end]
        if now is not None:
            samples.extend(now - req.arrived_at
                           for req in self._unserved_requests()
                           if since <= req.arrived_at < end)
        if not samples:
            return 0.0
        samples.sort()
        idx = min(int(len(samples) * pct / 100.0), len(samples) - 1)
        return samples[idx]

    def slo_attainment(self, slo_seconds: float, since: float = 0.0,
                       until: float | None = None) -> float:
        """Fraction of ARRIVALS meeting the TTFT SLO: requests still unserved
        at measurement time count as misses (no survivorship bias). ``until``
        bounds the arrival window."""
        end = float("inf") if until is None else until
        met = missed = 0
        for ts, t in self.ttft_samples:
            if not (since <= ts < end):
                continue
            if t <= slo_seconds:
                met += 1
            else:
                missed += 1
        missed += sum(1 for req in self._unserved_requests()
                      if since <= req.arrived_at < end)
        total = met + missed
        return met / total if total else 1.0
