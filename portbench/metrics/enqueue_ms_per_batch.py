"""enqueue_ms_per_batch (ms): the program's own spans around handing a
planned batch to the card inside runner.plan (plan.pack_epoch_wire,
synth.upload, synth.launch, shard.stack, quantize.pack and
runner.fetch_async), summed over the traced window, per runner.plan span.
Spans record only while a profiler does, so the table holds the traced
window alone; dividing by its own runner.plan count keeps both from the
same windows. None where the program has no span table or the table holds
none of these spans."""

PARTS = ("plan.pack_epoch_wire", "synth.upload", "synth.launch",
         "shard.stack", "quantize.pack", "runner.fetch_async")


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
