"""The yardstick of the kernel metrics: the H100's published peaks and the
least time each kernel call of the tracking path could take, from the bytes
it must move and the operations it must do at its shapes.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit):
HBM 3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores; 67 TFLOP/s float32
outside them. Each input byte is counted read once and each output byte
written once, whatever a kernel reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S) -> float:
    """The least seconds: the larger of bytes over HBM bandwidth and
    operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


def block_warp_bound_s(b: int, c: int, h: int, w: int, src_dtype: str) -> float:
    """One block warp of src [b, c, h, w] by a float32 flow [b, 2, h, w] into
    a float32 output: source, flow and output once; 8 float32 operations an
    output element (two weights a side, four taps)."""
    nbytes = b * c * h * w * _BYTES[src_dtype] + b * 2 * h * w * 4 + b * c * h * w * 4
    return bound_s(nbytes, 8.0 * b * c * h * w)


def corr_pairs(h: int, w: int, md: int, stride: int) -> int:
    """(pixel, displacement) pairs of one image whose displaced pixel lies on
    the image: the products the cost volume needs."""
    r = md // stride

    def on_image(n):
        return sum(1 for y in range(n) for i in range(-r, r + 1) if 0 <= y + i * stride < n)

    return on_image(h) * on_image(w)


def correlation_bound_s(b: int, c: int, h: int, w: int, md: int, stride: int,
                        dtype: str) -> float:
    """One cost volume of f1, f2 [b, c, h, w] into [b, D², h, w] float32: both
    inputs read and the volume written once; 2·c operations an on-image pair,
    on the bf16 tensor cores for bf16 inputs, as float32 FMAs otherwise."""
    d = 2 * (md // stride) + 1
    nbytes = 2 * b * c * h * w * _BYTES[dtype] + b * d * d * h * w * 4
    flops = 2.0 * b * corr_pairs(h, w, md, stride) * c
    peak = BF16_TC_FLOP_PER_S if dtype == "bfloat16" else FP32_FLOP_PER_S
    return bound_s(nbytes, flops, peak)


def flow_block_warps(cfg: dict) -> list:
    """The bound of each block warp one flow-net forward launches, in order:
    FlowNet2's two S refinements warp the second image in the compute dtype,
    its fusion warps it twice in float32 ([chunk, 3, infer_h, infer_w])."""
    f, p = cfg["flow"], cfg["pipeline"]
    if f.get("warp_impl", "block") != "block":
        return []
    n_s = {"flownetc": 0, "flownet2cs": 1, "flownet2css": 2, "flownet2": 2}[f["variant"]]
    shape = (p["scan_chunk"], 3, f["infer_height"], f["infer_width"])
    out = [block_warp_bound_s(*shape, p["dtype"])] * n_s
    if f["variant"] == "flownet2":
        out += [block_warp_bound_s(*shape, "float32")] * 2
    return out


def merge_block_warp(cfg: dict) -> float | None:
    """The bound of the merge's one block warp a frame: the objects' float32
    masks [1, max_objects, H / s, W / s] at warp stride s."""
    m, p = cfg["merge"], cfg["pipeline"]
    if m.get("warp_impl", "block") != "block":
        return None
    s = max(1, int(m.get("warp_stride", 1)))
    return block_warp_bound_s(1, p["max_objects"], p["image_height"] // s,
                              p["image_width"] // s, "float32")


def flownetc_correlation(cfg: dict) -> float:
    """The bound of FlowNetC's one cost volume a forward: conv3 features
    [chunk, 256, infer_h / 8, infer_w / 8] in the compute dtype."""
    f, p = cfg["flow"], cfg["pipeline"]
    return correlation_bound_s(p["scan_chunk"], 256, f["infer_height"] // 8,
                               f["infer_width"] // 8, f.get("max_displacement", 20),
                               f.get("corr_stride", 2), p["dtype"])
