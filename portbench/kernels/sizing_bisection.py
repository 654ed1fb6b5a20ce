"""Work of one sizing-bisection launch, counted from the plain version's
arithmetic at the launch's shapes: for each of the batch's rows, every
state it can hold (up to its k, at most the launch's ``k_cols``) is
evaluated in 48 bisection steps for each of two lanes (TTFT and ITL),
11 operations each (the state's log-probability, its clamp, the running
maximum, the weight's exponential with its shift, and the three weighted
sums), one of them an exponential. Bytes: the cumulative chain's needed
states read once, each row's 16 scalars (its 7 parameters, 2 targets, 4
bracket ends, the chain at k, and its 2 rates out) once, in float32."""

KERNEL = "sizing_bisection_kernel"
PASSES = 2 * 48
OPS_PER_STATE = 11


def work(call: dict) -> tuple[float, float]:
    ks = call["k"]
    states = sum(min(int(k), call["k_cols"]) for k in ks)
    return (float(PASSES * OPS_PER_STATE * states),
            float(4 * (states + 16 * len(ks))))
