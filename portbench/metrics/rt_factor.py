"""rt_factor (x_realtime): seconds of signal delivered to the sink over the
wall seconds of the whole window, the boundaries between runner calls
included."""


def read(run):
    return run.window.signal_s / run.window.seconds
