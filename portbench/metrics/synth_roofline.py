"""synth_roofline (%): the least time the card could take for the window's
epochs (peaks.epoch_least_seconds: the algorithm's operations at the
published integer issue rate, or its bytes at the HBM rate, whichever is
larger), over the device time of every compute kernel in the traced window
(copies left out). Whatever kernels do the synthesis step, the count is the
same."""


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    return 100.0 * run.check.least_time_s / run.trace.kernel_s
