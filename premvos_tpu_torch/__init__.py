"""premvos_tpu_torch — the PReMVOS video object segmentation pipeline in
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

A port of `premvos_tpu` (JAX), which stays in the repository as the
reference. Layout mirrors the JAX package module for module:

  config.py            the config tree (own copy; same JSON presets)
  bridge.py            flax parameter trees → the port's state dicts
  data/                preprocessing, the DAVIS / flow-pair / crop readers,
                       lucid-dream augmentation, and numpy versions of the
                       OpenCV calls the JAX package makes (cv_compat.py)
  ops/                 boxes, masks, crop/paste, NMS, RoIAlign, correlation,
                       resample2d, channelnorm, resize (each kernel-backed op
                       keeps its plain PyTorch version beside the kernel)
  kernels/             the CUDA C++ sources and their ctypes binding
  models/              ResNet, FPN, RPN, heads, Mask R-CNN, DeepLabv3+,
                       FlowNet2, ReID
  stages/              refine, flow (mask warps), ReID, merge/track
  pipeline/runner.py   build_models / init_params / run_sequence
  finetune/            per-video fine-tuning: fused (on the device) and
                       the host-pool oracle, and several videos at once
  train/               the Mask R-CNN, FlowNetC, ReID and refine trainers
  eval/metrics.py      train-time metrics

Entry points run on CUDA unless the caller passes device="cpu"; without a
card and without that argument they raise.
"""
