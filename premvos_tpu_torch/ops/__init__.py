"""Ops of the port (see the package docstring): the plain PyTorch versions,
and the wrappers that launch the CUDA kernels on CUDA tensors.

Exports `mask_iou`, as the JAX package's `premvos_tpu.ops` does. The
submodules keep their names: `from premvos_tpu_torch.ops import nms` gives
the module (the port's code imports them so), not a function.
"""

from premvos_tpu_torch.ops.masks import mask_iou

__all__ = ["mask_iou"]
