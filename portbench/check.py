"""What decides `correct`: the program's outputs in the window against the
reference pipeline (portbench/reference), which imports nothing of the
program and takes none of its weights.

For each checked sequence the benchmark keeps what the timed path produced:
the labels on the host, and through forward hooks on the program's nets each
net's outputs (and, in the chunks drawn for the net check, the RPN head's
outputs, the box head's input and outputs and the refinement classifier's
logits). Six numbers; a configuration's file gives the limit of each it
compares:

- labels: the share of the checked sequences' pixels, every frame, where
  the program's labels differ from those of the reference's stages and
  merge run over the program's net outputs (crops, pastes, flow resizes,
  warps, scores, greedy assignment, intro frames, chunk padding: all
  recomputed by the reference);
- detections: the share of the detection slots of the checked chunks'
  real frames where the program's detections (valid flag, box, score)
  differ from the reference's selection run on the program's own RPN and
  box head outputs: proposal decoding and clipping, both NMS passes, the
  box decoding and the score threshold;
- maskrcnn: the worst part's distance from the float32 reference (in units
  of the bf16 reference's, below), each part pooled over every checked
  chunk: the RPN's logits and deltas (reference backbone, FPN and head on
  the frames), the box head's RoI features (reference RoIAlign of the
  reference features at the reference's proposals), the box head's outputs
  (reference head on the program's RoI features) and the mask logits of
  every kept detection (reference features, RoIAlign and head at the
  program's boxes);
- refine: the same for the refinement classifier's two logits (before the
  resize to the crop and the difference that cancels most of their size),
  the reference cutting the crops from the frames at the program's boxes;
  and the net's output against that resize and difference of the program's
  own logits;
- flow: the same for the flow net's output on each real pair;
- reid: the same for the ReID embeddings of every kept detection and of
  each object's entry-frame crop.

Nets are compared on the chunks drawn from the seed, real frames only, the
reference in float32 (TF32 off), its stages at the configuration's operand
precisions.
"""

from __future__ import annotations

import sys

import torch

from portbench.reference import ops, pipeline as ref
from portbench.reference.nets import logit_difference as nets_logit_difference
from portbench.weights import load, make_weights

NUMBERS = ("labels", "detections", "maskrcnn", "refine", "flow", "reid")
# A detection slot differs where its valid flag does, or where a kept box
# lies further than BOX_PX from the reference's or its score further than
# SCORE: both sides decode the same float32 values with the same operations.
BOX_PX, SCORE = 1e-3, 1e-6


class Capture:
    """Forward hooks on a system's nets that keep what they return while a
    checked sequence runs: references to the tensors, no copy and no device
    work. Each net's outputs in call order; in the chunks drawn for the net
    check also the RPN head's outputs, the box head's input and outputs and
    the refinement net's classifier logits."""

    def __init__(self, models):
        self.on, self.rec, self.net_chunks = False, None, set()
        self.handles = []
        for name in ref.Models._fields:
            self.handles.append(getattr(models, name).register_forward_hook(self._keep(name)))
        det = models.maskrcnn
        # The proposal net's parts run before its chunk's outputs are kept,
        # the refinement net after.
        self.handles.append(det.rpn.register_forward_hook(self._keep_part("rpn", 0)))
        self.handles.append(det.box_head.register_forward_hook(self._keep_part("box", 0, True)))
        self.handles.append(models.refine.cls.register_forward_hook(self._keep_part("cls", 1)))

    def _keep(self, name):
        def hook(module, args, out):
            if self.on:
                self.rec[name].append(out)
        return hook

    def _keep_part(self, name, offset, with_input=False):
        def hook(module, args, out):
            if not self.on:
                return
            chunk = len(self.rec["maskrcnn"]) - offset
            if chunk in self.net_chunks:
                self.rec[name].setdefault(chunk, []).append((args[0], out) if with_input else out)
        return hook

    def start(self, net_chunks):
        self.on, self.net_chunks = True, set(net_chunks)
        self.rec = {"maskrcnn": [], "refine": [], "flow": [], "reid": [], "rpn": {}, "box": {},
                    "cls": {}}

    def stop(self) -> dict:
        self.on = False
        rec, self.rec = self.rec, None
        return rec

    def remove(self):
        for h in self.handles:
            h.remove()


class _Replay:
    """Stands in for a net: returns the program's outputs in call order."""

    def __init__(self, outs):
        self.outs = list(outs)

    def __call__(self, *args):
        if not self.outs:
            raise IndexError("the replay ran out of the program's outputs")
        return self.outs.pop(0)


def _labels_number(cfg, seq, labels, rec, device) -> float:
    replay = ref.Models(*(_Replay(rec[name]) for name in ref.Models._fields))
    want = ref.Pipeline(cfg, replay, device).run_sequence(
        seq.frames, seq.gt_masks, seq.num_objects, seq.intro_frames)
    want = want.cpu().numpy()
    if want.shape != labels.shape:
        return 1.0
    return float((want != labels).mean())


class _Pooled:
    """Each part of each net: the program's distance from the float32
    reference, ‖got − ref32‖₂, in units of the distance that bf16 computation
    puts the reference itself from it on the same inputs, ‖ref16 − ref32‖₂
    (how far rounding at bf16 moves this seed's random net), each pooled over
    every chunk and sequence checked in a run (sums of squares, float64)."""

    def __init__(self):
        self.sums = {}  # (net, part): [Σ (got − ref32)², Σ (ref16 − ref32)²]

    def add(self, net, part, got, want32, want16):
        s = self.sums.setdefault((net, part), [0.0, 0.0])
        if got.shape != want32.shape:
            s[0] = float("inf")
            return
        want32 = want32.double()
        s[0] += torch.sum((got.double() - want32) ** 2).item()
        s[1] += torch.sum((want16.double() - want32) ** 2).item()

    def fail(self, net):
        self.sums[(net, "failed")] = [float("inf"), 1.0]

    def number(self, net) -> float:
        """The worst part of `net`."""
        out = 0.0
        for (name, _), (num, yard) in self.sums.items():
            if name == net and num > 0.0:
                out = max(out, (num / yard) ** 0.5 if yard > 0.0 else float("inf"))
        return out


def _slots_apart(det, boxes, scores, valid) -> int:
    """The detection slots where the program's `det` and the reference's
    (boxes, scores, valid) differ."""
    got_v = det["valid"]
    box_off = (det["boxes"].to(torch.float32) - boxes).abs().amax(-1) > BOX_PX
    score_off = (det["scores"].to(torch.float32) - scores).abs() > SCORE
    return int(((got_v != valid) | ((got_v | valid) & (box_off | score_off))).sum())


def _add_nets(pool, slots, cfg, nets, seq, rec, chunks, device) -> None:
    """Each net's outputs on `chunks` of the sequence against the reference:
    `nets` the reference's nets in float32 and in bfloat16; `slots` the
    [differing, compared] detection slots."""
    p, r = cfg.pipeline, cfg.refine
    n32, n16 = nets
    pipe = ref.Pipeline(cfg, n32, device)
    both = (n32, n16)
    with torch.inference_mode(), ref.float32_matmuls():
        frames = torch.as_tensor(seq.frames, device=device).to(torch.float32) / 255.0
        gt = torch.as_tensor(seq.gt_masks, device=device).to(torch.float32)
        k = gt.shape[0]
        on = torch.arange(k, device=device) < seq.num_objects
        intro = torch.as_tensor(seq.intro_frames, device=device).to(torch.int64)
        imgs0 = ref.normalize(frames[intro]).permute(0, 3, 1, 2)
        crops = ref.reid_crops(imgs0, ref.boxes_from_masks(gt)[:, None], cfg.reid.crop_size)
        pool.add("reid", "entry", rec["reid"][0][on], *(m.reid(crops[:, 0])[on] for m in both))
        plan = ref.chunk_indices(frames.shape[0], p.scan_chunk)
        for c in chunks:
            ts, idx = plan[c]
            real = [i for i, t in enumerate(ts) if t > 0]
            cur, prev = ref.chunk_frames(frames, ts, idx)
            imgs = ref.normalize(cur).permute(0, 3, 1, 2)
            det = rec["maskrcnn"][c]
            boxes, valid = det["boxes"], det["valid"]
            n = boxes.shape[1]
            v = valid[real]
            feats = [m.maskrcnn.fpn(m.maskrcnn.backbone(imgs[real])) for m in both]
            rpn_logits, rpn_deltas = {}, {}
            for (lg, dl), lvl in zip(rec["rpn"][c], feats[0]):
                rpn_logits[lvl], rpn_deltas[lvl] = lg, dl
                (lg32, dl32), (lg16, dl16) = (m.maskrcnn.rpn(f[lvl]) for m, f in zip(both, feats))
                pool.add("maskrcnn", "rpn_logits", lg[real], lg32, lg16)
                pool.add("maskrcnn", "rpn_deltas", dl[real], dl32, dl16)
            (box_in, (cls, deltas)), = rec["box"][c]
            # The selection over the program's own head outputs: its
            # proposals from its RPN outputs, its detections from its box
            # head's outputs on them.
            hw = tuple(imgs.shape[-2:])
            rois, roi_valid = n32.maskrcnn.proposals(rpn_logits, rpn_deltas, pipe.anchors, hw)
            want = n32.maskrcnn.detections(rois, roi_valid, cls, deltas, hw)
            slots[0] += _slots_apart({k: x[real] for k, x in det.items() if k != "mask_logits"},
                                     *(x[real] for x in want))
            slots[1] += len(real) * det["valid"].shape[1]
            rows = box_in.shape[0] // len(ts)
            sel = torch.cat([torch.arange(i * rows, (i + 1) * rows, device=device) for i in real])
            for j, i in enumerate(real):  # one frame's RoIs at a time: the gathers' memory
                one = [{k: v[j:j + 1] for k, v in f.items()} for f in feats]
                got_in = box_in[i * rows:(i + 1) * rows]
                pool.add("maskrcnn", "box_features", got_in, *(
                    ops.multilevel_roi_align(f, rois[i:i + 1], cfg.proposal.roi_align_size)
                    .reshape(got_in.shape) for f in one))
            (cls32, d32), (cls16, d16) = (m.maskrcnn.box_head(box_in[sel]) for m in both)
            pool.add("maskrcnn", "box_logits", cls[sel], cls32, cls16)
            pool.add("maskrcnn", "box_deltas", deltas[sel], d32, d16)
            m32, m16 = (m.maskrcnn.masks(f, boxes[real])[v] for m, f in zip(both, feats))
            pool.add("maskrcnn", "mask_logits", det["mask_logits"][real][v], m32, m16)
            del feats

            rc, _ = ref.make_refine_crops(imgs, boxes, det["mask_logits"], r.crop_size,
                                          r.box_margin, pipe.interp)
            got = rec["refine"][c].reshape(len(ts), n, r.crop_size, r.crop_size)
            (got_cls,) = rec["cls"][c]
            if got_cls.shape[0] != len(ts) * n:  # the classifier saw another batch
                pool.fail("refine")
            else:
                got_cls = got_cls.reshape(len(ts), n, *got_cls.shape[1:])
                for i in real:  # one frame's crops at a time: the float32 net's memory
                    vi = valid[i]
                    if not vi.any():
                        continue
                    pool.add("refine", "logits", got_cls[i][vi],
                             *(m.refine.head(rc[i][vi]) for m in both))
                    # The net's output is the resize and difference of those
                    # logits (float32 on both sides: equal but for reordered sums).
                    post = nets_logit_difference(got_cls[i][vi], r.crop_size)
                    if torch.linalg.vector_norm(got[i][vi] - post) > 1e-4 * torch.linalg.vector_norm(post):
                        pool.fail("refine")
            fin = ref.flow_inputs(cur[real], prev[real], (cfg.flow.infer_height,
                                                          cfg.flow.infer_width))
            pool.add("flow", "flow", rec["flow"][c][real], *(m.flow(*fin) for m in both))
            emb = rec["reid"][c + 1].reshape(len(ts), n, -1)[real][v]
            crops = ref.reid_crops(imgs[real], boxes[real], cfg.reid.crop_size)[v]
            pool.add("reid", "proposals", emb, *(m.reid(crops) for m in both))


def judge(cfg_path, seed: int, device, checked: list) -> dict:
    """{number: value} over `checked`, a list of (sequence, labels [T, H, W]
    int32 on the host, the Capture record, the chunks whose nets to check):
    labels the share of every checked pixel, the nets pooled over every
    checked chunk."""
    cfg = ref.load_config(cfg_path)
    weights = make_weights(cfg, seed, device)
    nets = tuple(ref.build_models(cfg, dtype, device) for dtype in (torch.float32, torch.bfloat16))
    for m in nets:
        load(m, weights)
    del weights
    pool, wrong, pixels, slots = _Pooled(), 0.0, 0, [0, 0]
    for seq, labels, rec, chunks in checked:
        try:
            wrong += _labels_number(cfg, seq, labels, rec, device) * labels.size
            pixels += labels.size
            _add_nets(pool, slots, cfg, nets, seq, rec, chunks, device)
        except (IndexError, KeyError) as e:  # a net ran fewer times than the sequence needs
            print(f"portbench: {seq.name}: the program's outputs are incomplete: {e!r}",
                  file=sys.stderr)
            return dict.fromkeys(NUMBERS, float("inf"))
    out = {"labels": wrong / pixels, "detections": slots[0] / max(slots[1], 1)}
    out.update({net: pool.number(net) for net in NUMBERS[2:]})
    return out
