"""d2h_gb_per_s (GB/s): the bytes delivered to the sink in the traced
window over the device time of its device-to-host copies. On the sharded
path the runner reads back exactly the delivered epochs' samples (the
profiler's raw events carry no memcpy sizes)."""


def read(run):
    t = run.trace
    if t is None or t.dtoh_s <= 0 or run.window.delivered_bytes <= 0:
        return None
    return run.window.delivered_bytes / t.dtoh_s / 1e9
