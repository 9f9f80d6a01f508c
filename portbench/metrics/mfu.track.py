"""mfu.track: the model FLOPs of the tracked frames (the configuration
file's `flops_per_tracked_frame`, counted on the reference at the cell's
shapes, padding frames not counted) over the traced window's seconds, as a
share of the H100's 989 TFLOP/s bf16 peak."""

from portbench import roofline


def read(trace):
    flops = trace.cfg["flops_per_tracked_frame"] * trace.tracked_frames
    return 100.0 * flops / trace.window_s / roofline.BF16_TC_FLOP_PER_S
