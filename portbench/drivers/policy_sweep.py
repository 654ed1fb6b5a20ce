"""The offline policy sweep: grid searches back to back, search ``i`` of a
run splitting its train and holdout world seeds from sweep seed
``--seed + i``. Each search scores the default knob grid on the train
seeds in chunks of worlds, one launch of the horizon-scan kernel a chunk,
and trust-gates the winner on the holdout seeds.

The scenario's physics come from the configuration (latency law, batch,
chips, SLO, start-up, stabilisation) and the traffic file's ``world``
(request sizes, horizon, step, queue bound, replica cap, objective
weights, fault windows); the true rate is the traffic's load cycle,
sampled at step midpoints.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.drivers import probes
from portbench.worlds.loadgen import trapezoid


class WindowClosed(Exception):
    """Raised at the next chunk once the measured window has closed."""


def scenario(config: dict, traffic: dict) -> dict:
    """The fluid world's parameters: the deployment's and the traffic's."""
    alpha, beta, gamma = config["latency_parms_ms"]
    return dict(alpha_ms=alpha, beta_ms=beta, gamma_ms=gamma,
                max_batch=config["max_batch_size"],
                chips_per_replica=config["chips_per_replica"],
                slo_ttft_s=config["slo_ttft_ms"] / 1000.0,
                startup_s=config["startup_s"],
                down_stabilization_s=config["hpa"]
                ["stabilization_down_seconds"],
                **traffic["world"])


def rate_table(traffic: dict, scene: dict) -> np.ndarray:
    """``[1, T]`` float32: the load cycle at each step's midpoint."""
    load = traffic["load"]
    steps = int(round(scene["horizon_s"] / scene["dt"]))
    t = (np.arange(steps, dtype=np.float64) + 0.5) * scene["dt"]
    cycle = trapezoid(load["base_rps"], load["peak_rps"], load["ramp_up_s"],
                      load["hold_s"], load["ramp_down_s"], tail=load["tail_s"],
                      delay=load["delay_s"])
    return np.maximum(cycle.rate_at(t), 0.0)[None, :].astype(np.float32)


class Driver:
    def __init__(self, config, traffic, seed, device, rec):
        from wva_tpu_torch.sweep import world

        self.config, self.traffic = config, traffic
        self.seed, self.device, self.rec = seed, device, rec
        self.scene = scenario(config, traffic)
        self.params = world.WorldParams(**self.scene)
        self.lam = rate_table(traffic, self.scene)
        self.searches = 0
        self.deadline = float("inf")
        self.done = {"worlds": 0}
        self.patches = probes.Patches()
        probes.kernel_launches(self.patches, rec)
        self._wrap_chunks(world)

    def _wrap_chunks(self, world):
        """``chunk_tensors`` and ``run_chunk``: a chunk runs from its knob
        rows' staging to its outputs on the device, which the host clock
        times (synchronised, as the transfer after it would be); the chunk
        before it has been read back by then, so its worlds count as
        done. Past the window's close the next chunk does not start."""
        rec, done, sync = self.rec, self.done, self._sync
        state = {"t0": None, "pending": 0}

        def tensors(inner):
            def chunk_tensors(*args, **kwargs):
                if rec.recording:
                    done["worlds"] += state["pending"]
                    state["pending"] = 0
                    if time.perf_counter() >= self.deadline:
                        raise WindowClosed
                state["t0"] = time.perf_counter()
                return inner(*args, **kwargs)
            return chunk_tensors

        def chunk(inner):
            def run_chunk(params, knob_rows, lam_t, arrivals, faults,
                          init_replicas):
                with probes.labelled("chunk"):
                    out = inner(params, knob_rows, lam_t, arrivals, faults,
                                init_replicas)
                    sync()
                if rec.recording:
                    rec.timers["chunk"].append(
                        1e3 * (time.perf_counter() - state["t0"]))
                    slot = rec.slot("scan")
                    if slot is not None:
                        rec.keep("scan", slot, (knob_rows, lam_t, arrivals,
                                                faults, init_replicas, out))
                    state["pending"] = int(knob_rows.shape[0])
                return out
            return run_chunk

        self.patches.replace(world, "chunk_tensors", tensors)
        self.patches.replace(world, "run_chunk", chunk)
        self._state = state
        self._label(world, "arrivals_table", "tables")
        self._label(world, "fault_table", "tables")
        from wva_tpu_torch.sweep import search

        self._label(search, "run_worlds", "run worlds")

    def _label(self, owner, attr, label):
        """Name the calls of ``owner.attr`` as a host range in a trace."""
        def make(inner):
            def labelled(*args, **kwargs):
                with probes.labelled(label):
                    return inner(*args, **kwargs)
            return labelled

        self.patches.replace(owner, attr, make)

    def _sync(self):
        import torch

        if torch.device(self.device or "cuda").type == "cuda":
            torch.cuda.synchronize()

    def search(self, sweep_seed: int) -> dict:
        from wva_tpu_torch.sweep import search

        s = self.traffic["search"]
        with probes.labelled("search"):
            return search.run_sweep(
                self.params, self.lam, [self.config["model_id"]],
                algo="grid", grid=s["grid"], n_train=s["train_seeds"],
                n_holdout=s["holdout_seeds"],
                sweep_seed=sweep_seed % (1 << 31), chunk=s["chunk"],
                device=self.device)

    def warm_up(self):
        """The run's first search, unrecorded: every shape the window runs
        (the train chunks and the holdout's smaller one), the scan kernel
        built, loaded and run, and every host path of a search taken."""
        self.search(self.seed)

    def window(self, seconds: float):
        start = time.perf_counter()
        self.deadline = start + seconds
        try:
            while True:
                self.search(self.seed + self.searches)
                self.searches += 1
                self.done["worlds"] += self._state["pending"]
                self._state["pending"] = 0
        except WindowClosed:
            pass
        self.rec.window = (start, time.perf_counter())

    def end_to_end(self) -> dict:
        start, end = self.rec.window
        return {"sweep_worlds_per_s": self.done["worlds"] / (end - start)}

    def counts(self) -> tuple[int, int]:
        return self.done["worlds"], 0

    def close(self):
        self.patches.restore()
