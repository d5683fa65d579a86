"""fetch_ms_per_batch (ms): the runner's own host clock around its wait on
each batch's readback event (RunStats.fetch_seconds) per device batch."""


def read(run):
    stats = run.window.stats
    if not stats.get("device_batches"):
        return None
    return 1e3 * stats["fetch_seconds"] / stats["device_batches"]
