"""nets.flow_ms: device milliseconds per tracked frame of the kernels
launched inside the flow net's forward (models/flownet.py: FlowNet2 or
FlowNetC, its cost volume and in-net warps), padding frames' work
included."""


def read(trace):
    ns = sum(op.end_ns - op.start_ns for op in trace.kernels() if op.owner == "flow")
    return ns / 1e6 / trace.tracked_frames if ns else None
