"""File codecs at the I/O edge and the checkpoint converters (port of
premvos_tpu/io_compat): COCO RLE (numpy and the C++ codec), proposals JSON,
.flo, PNG, the PNM family, JPEG, orbax checkpoints (read and written), and
the TF, torchvision-ResNet and flownet2-pytorch converters into the port's
modules."""

from premvos_tpu_torch.io_compat import rle, rle_native
from premvos_tpu_torch.io_compat.convert_tf import convert_tf_dict, load_tf_checkpoint_vars
from premvos_tpu_torch.io_compat.convert_tf_maskrcnn import convert_tf_maskrcnn
from premvos_tpu_torch.io_compat.convert_tf_refine import convert_tf_refine
from premvos_tpu_torch.io_compat.convert_tf_reid import convert_tf_reid
from premvos_tpu_torch.io_compat.flo import read_flo, write_flo
from premvos_tpu_torch.io_compat.proposals_json import (
    FrameProposals,
    load_proposals,
    save_proposals,
)

__all__ = [
    "rle", "rle_native", "read_flo", "write_flo",
    "FrameProposals", "load_proposals", "save_proposals",
    "convert_tf_dict", "load_tf_checkpoint_vars",
    "convert_tf_maskrcnn", "convert_tf_refine", "convert_tf_reid",
]
