"""stages.outside_nets_ms: device milliseconds per tracked frame of every
kernel launched outside the four nets' forwards: crops and pastes, flow
resizes, ReID crops, the merge (stages/), the sequence's set-up."""


def read(trace):
    ns = sum(op.end_ns - op.start_ns for op in trace.kernels() if op.owner is None)
    return ns / 1e6 / trace.tracked_frames if ns else None
