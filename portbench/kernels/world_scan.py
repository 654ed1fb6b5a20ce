"""Work of one horizon-scan launch, counted from the plain version's
arithmetic (``run_chunk_plain``'s step) at the launch's shapes: each
(world, model) lane takes 110 operations a step (serving: 22, observation
and health: 12, the forecast and its trust: 30, sizing: 12, the
controller's gating: 20, actuation and the pipeline: 14), six of them
divisions, over ``steps`` steps. Bytes: the knob rows, the true rates,
the arrivals and fault flags, and the four outputs, float32, once each."""

KERNEL = "world_scan_kernel"
OPS_PER_LANE_STEP = 110


def work(call: dict) -> tuple[float, float]:
    t, w, m = call["steps"], call["worlds"], call["models"]
    ops = OPS_PER_LANE_STEP * t * w * m
    nbytes = 4 * (w * call["knobs"] + t * m + 2 * t * w * m + 4 * w * m)
    return float(ops), float(nbytes)
