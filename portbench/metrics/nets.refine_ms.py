"""nets.refine_ms: device milliseconds per tracked frame of the kernels
launched inside the refinement net's forward (models/deeplab.py, on the
32 crops of each frame), padding frames' work included."""


def read(trace):
    ns = sum(op.end_ns - op.start_ns for op in trace.kernels() if op.owner == "refine")
    return ns / 1e6 / trace.tracked_frames if ns else None
