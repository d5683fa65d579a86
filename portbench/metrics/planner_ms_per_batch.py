"""planner_ms_per_batch (ms): the program's own spans around the NumPy
planner inside runner.plan (plan.plan_epochs, plan.pad_epochs and, on the
closed impls, plan.plan_batch), summed over the traced window, per
runner.plan span. Spans record only while a profiler does, so the table
holds the traced window alone; dividing by its own runner.plan count keeps
both from the same windows. None where the program has no span table or
the table holds none of these spans."""

PARTS = ("plan.plan_epochs", "plan.pad_epochs", "plan.plan_batch")


def read(run):
    if run.trace is None:
        return None
    try:
        from gps_sdr_sim_tpu_torch import spans
    except ImportError:
        return None
    table = spans.totals()
    batches = table.get("runner.plan", (0, 0.0))[0]
    found = [table[name][1] for name in PARTS if name in table]
    if not batches or not found:
        return None
    return 1e3 * sum(found) / batches
