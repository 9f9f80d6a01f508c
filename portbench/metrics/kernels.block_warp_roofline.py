"""kernels.block_warp_roofline: the block warp's share of its roofline
(ops/resample2d.py → kernels/resample2d.cu, kernels named resample_block*):
the least time of each recorded call, from its shape's bytes at the HBM
bandwidth (portbench/roofline.py), summed, over the calls' device time.
Calls inside the flow net take the flow net's warps in launch order (each
forward starts the list again); the others are the merge's, one a frame."""

from portbench import roofline

PATTERN = "resample_block"


def read(trace):
    flow_calls = roofline.flow_block_warps(trace.cfg)
    merge = roofline.merge_block_warp(trace.cfg)
    bound = spent = 0.0
    i, prev_owner = 0, None
    for op in trace.kernels():
        if op.owner == "flow" and prev_owner != "flow":
            i = 0  # a new forward of the flow net
        prev_owner = op.owner
        if PATTERN not in op.name:
            continue
        if op.owner == "flow":
            if i >= len(flow_calls):
                continue
            bound += flow_calls[i]
            i += 1
        elif merge is not None:
            bound += merge
        else:
            continue
        spent += (op.end_ns - op.start_ns) / 1e9
    return 100.0 * bound / spent if spent else None
