"""The model FLOPs of one tracked frame at a configuration, counted on the
reference (torch's FlopCounterMode: convolutions, matmuls, einsums) on the
meta device at the cell's shapes: stages 1-4 of one chunk of
`pipeline.scan_chunk` frames and the merge of each, over the chunk. The
count is kept as data in the configuration file (`flops_per_tracked_frame`)
for mfu.track; a test holds the two equal.

    python3 -m portbench.flops portbench/configs/<name>.json
"""

from __future__ import annotations

import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import pipeline as ref


def flops_per_tracked_frame(cfg) -> int:
    p = cfg.pipeline
    c, h, w, k = p.scan_chunk, p.image_height, p.image_width, p.max_objects
    models = ref.build_models(cfg, ref.DTYPES[p.dtype], "meta")
    pipe = ref.Pipeline(cfg, models, "meta")
    frames = torch.rand((c, h, w, 3), device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        outs = ref.stages_batch(models, cfg, pipe.anchors, frames, frames, pipe.interp)
        state = ref.TrackState(torch.rand((k, h, w), device="meta"),
                               torch.rand((k, cfg.reid.embedding_dim), device="meta"),
                               torch.ones((k,), dtype=torch.bool, device="meta"),
                               torch.zeros((k,), dtype=torch.int32, device="meta"))
        none = torch.zeros((k,), dtype=torch.bool, device="meta")
        for i in range(c):
            ref.merge_frame(state, *(x[i] for x in outs), cfg.merge, none, state.prev_masks)
    return counter.get_total_flops() // c


if __name__ == "__main__":
    print(flops_per_tracked_frame(ref.load_config(sys.argv[1])))
