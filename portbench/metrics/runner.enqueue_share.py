"""runner.enqueue_share: the share of the window the host spends inside the
program's `run_sequence` calls (each from its call to its return, before
the labels are read back): how far the host paces a sequence. Read from
the benchmark's own clock around each call."""


def read(trace):
    return 100.0 * trace.host_run_s / trace.window_s
