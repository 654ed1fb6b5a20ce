"""Work of one EKF observation-and-jacobian launch, counted from the plain
version's arithmetic (the chain statistics at the clipped rate,
differentiated forward in the three service parameters) at the launch's
shape: every state the queue can hold (``k`` of the environment) costs 25
operations for the value (its service rate and log, the cumulative sum,
the log-ratio, the normalisation's maximum, shift, exponential and sum,
the probability and the two weighted sums), and each of the three
tangents twice that. Bytes: x (3), env (5) and the [2, 4] result, float32,
once each."""

KERNEL = "chain_jacobian_kernel"
OPS_PER_STATE = 25 * (1 + 2 * 3)


def work(call: dict) -> tuple[float, float]:
    k = int(round(call["env"][4]))
    return float(OPS_PER_STATE * k), float(4 * (3 + 5 + 8))
