"""The EKF tuner: host-clock ms of each tuner step that ran (the
benchmark's wrapper around ``TunerController.observe``), mean over the
window's steps."""


def read(ctx):
    steps = ctx.rec.timers.get("tuner_step", [])
    return sum(steps) / len(steps) if steps else None
