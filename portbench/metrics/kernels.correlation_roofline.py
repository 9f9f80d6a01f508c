"""kernels.correlation_roofline: the cost volume's share of its roofline
(ops/correlation.py → kernels/correlation.cu, kernels named corr_kernel):
each recorded forward's least time from the bytes of FlowNetC's features
and volume or its on-image products on the bf16 tensor cores, whichever
bounds (portbench/roofline.py), summed, over their device time."""

from portbench import roofline

PATTERN = "corr_kernel"


def read(trace):
    calls = [op for op in trace.kernels() if PATTERN in op.name]
    spent = sum(op.end_ns - op.start_ns for op in calls) / 1e9
    if not spent:
        return None
    return 100.0 * len(calls) * roofline.flownetc_correlation(trace.cfg) / spent
