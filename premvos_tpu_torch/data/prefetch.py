"""Host → device input prefetch (port of premvos_tpu/data/prefetch.py).

A small thread pool loads the next sequences (PNG decode, padding) while
the device tracks the current one, and copies each one's arrays to the
device on a stream of its own, so the copy overlaps the current sequence's
work too. The consumer's stream waits on an event recorded after the copy,
so no kernel of the consumer reads a tensor before its copy has finished.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from premvos_tpu_torch.pipeline.runner import resolve_device

ON_DEVICE = ("frames", "gt_masks", "intro_frames")


def _upload(seq: dict, device: torch.device) -> tuple[dict, object]:
    """Copy seq's ON_DEVICE arrays to `device` → (seq, event to wait on, or
    None on the CPU)."""
    seq = dict(seq)
    if device.type != "cuda":
        for k in ON_DEVICE:
            seq[k] = torch.from_numpy(seq[k]).to(device)
        return seq, None
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        for k in ON_DEVICE:
            seq[k] = torch.from_numpy(seq[k]).pin_memory().to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return seq, done


def prefetch_sequences(
    dataset,
    names,
    height: int,
    width: int,
    max_objects: int,
    max_frames=None,
    depth: int = 2,
    device=None,
):
    """Yield (name, seq_dict) in the order of `names`, with `frames`,
    `gt_masks` and `intro_frames` already on `device` (CUDA unless given),
    loading `depth` sequences ahead."""
    device = resolve_device(device)

    def load(name):
        seq = dataset.load_sequence(name, height, width, max_objects, max_frames)
        return _upload(seq, device)

    names = list(names)
    with ThreadPoolExecutor(max_workers=depth) as pool:
        futures = {}
        for name in names[:depth]:
            futures[name] = pool.submit(load, name)
        for i, name in enumerate(names):
            nxt = i + depth
            if nxt < len(names):
                futures[names[nxt]] = pool.submit(load, names[nxt])
            seq, done = futures.pop(name).result()
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                for k in ON_DEVICE:
                    # The copies' memory belongs to their stream: tell the
                    # allocator the consumer's stream uses it too.
                    seq[k].record_stream(current)
            yield name, seq
