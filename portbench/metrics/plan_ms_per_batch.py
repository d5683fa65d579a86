"""plan_ms_per_batch (ms): the runner's own host clock around planning,
staging and enqueueing (RunStats.plan_seconds) per device batch."""


def read(run):
    stats = run.window.stats
    if not stats.get("device_batches"):
        return None
    return 1e3 * stats["plan_seconds"] / stats["device_batches"]
