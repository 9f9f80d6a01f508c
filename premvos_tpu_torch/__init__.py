"""premvos_tpu_torch — the PReMVOS video object segmentation pipeline in
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

A port of `premvos_tpu` (JAX), which stays in the repository as the
reference. Layout mirrors the JAX package module for module:

  config.py            the config tree (own copy; same JSON presets)
  bridge.py            flax parameter trees → the port's state dicts
  data/                preprocessing, the DAVIS / flow-pair / crop readers,
                       sequence prefetch, lucid-dream augmentation, and
                       numpy versions of the OpenCV calls the JAX package
                       makes (cv_compat.py)
  io_compat/           PNG (numpy + zlib), JPEG (host C++) and PNM
                       readers, no Pillow; .flo, RLE (numpy and C++), the
                       proposals JSON, orbax checkpoints read (zarr v2
                       and v3, OCDBT, zstd) and written, and the
                       checkpoint converters (TF Mask R-CNN, refine and
                       ReID nets, torchvision ResNet, flownet2-pytorch)
  ops/                 boxes, masks, crop/paste, NMS, RoIAlign, correlation,
                       resample2d, channelnorm, resize (each kernel-backed op
                       keeps its plain PyTorch version beside the kernel)
  kernels/             the CUDA C++ sources and their ctypes binding, and
                       the host C++ JPEG decoder and RLE codec
  models/              ResNet, FPN, RPN, heads, Mask R-CNN, DeepLabv3+,
                       FlowNet2, ReID
  stages/              proposals, refine, flow (and mask warps), ReID,
                       merge/track
  pipeline/            runner.py (build_models / init_params /
                       run_sequence / precompute_sequence and the merge
                       replay) and the command lines run_davis.py and
                       run_stages.py
  finetune/            per-video fine-tuning: fused (on the device) and
                       the host-pool oracle, and several videos at once
  train/               the Mask R-CNN, FlowNetC, ReID and refine trainers
  eval/                DAVIS J&F (davis_eval.py), the merge-tuning harness
                       and train-time metrics
  utils/               logging, and checkpoints of the four nets: torch.save
                       files or orbax directories the JAX package reads

Entry points run on CUDA unless the caller passes device="cpu"; without a
card and without that argument they raise.
"""
