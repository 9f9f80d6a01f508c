"""flownet2-pytorch checkpoint → the port's FlowNet2 state dict (port of
premvos_tpu/io_compat/convert_flownet.py).

A user with the reference's `FlowNet2_checkpoint.pth.tar` loads it so:

    sd = torch.load(path, map_location="cpu")["state_dict"]
    state, unused = convert_flownet2_state_dict(sd, models.flow)
    models.flow.load_state_dict(state)

Keys map to the flax paths the JAX package uses, which name the port's
layers too:

    flownetc.conv1.0.*            → flownetc.encoder.conv1.Conv_0
    flownetc.conv_redir.0.*       → flownetc.conv_redir.Conv_0
    flownetc.deconv5.0.*          → flownetc.decoder.deconv5.ConvTranspose_0
    flownetc.predict_flow6.*      → flownetc.decoder.predict_flow6.Conv_0
    flownetc.upsampled_flow6_to_5.* → flownetc.decoder.upsampled_flow6_to_5.ConvTranspose_0
    (the same for flownets_1, flownets_2, flownetsd and flownetfusion)

flownet2-pytorch's Conv2d (OIHW) and ConvTranspose2d ((I, O, kh, kw))
weights are already in the port's layouts: the JAX converter's transpose
and spatial flip into flax, and bridge.py's flip back, cancel. So the
tensors are copied as they are.
"""

from __future__ import annotations

import re

from premvos_tpu_torch.bridge import flax_targets
from premvos_tpu_torch.io_compat.convert_tf import state_with

_ENCODER_CONVS = {"conv1", "conv2", "conv3"}  # FlowNetC's shared tower


def _torch_key_to_path(key: str) -> tuple[str, ...] | None:
    """A flownet2-pytorch key → its flax path, or None for keys no layer
    takes (e.g. the batch norms of the BN variants)."""
    parts = key.split(".")
    if parts[-1] not in ("weight", "bias"):
        return None
    leaf = "kernel" if parts[-1] == "weight" else "bias"
    net, rest = parts[0], parts[1:-1]
    if not rest:
        return None
    layer = rest[0]
    if re.fullmatch(r"deconv\d|upsampled_flow\d_to_\d", layer):
        return (net, "decoder", layer, "ConvTranspose_0", leaf)
    if re.fullmatch(r"predict_flow\d", layer):
        return (net, "decoder", layer, "Conv_0", leaf)
    if net == "flownetc" and layer in _ENCODER_CONVS:
        return (net, "encoder", layer, "Conv_0", leaf)
    if re.fullmatch(r"(conv\w*|conv_redir|inter_conv\d)", layer):
        return (net, layer, "Conv_0", leaf)
    return None


def convert_flownet2_state_dict(state_dict: dict, module) -> tuple[dict, list]:
    """A flownet2-pytorch state dict → (`module`'s state dict, the keys no
    parameter took). Raises on a shape mismatch and if any parameter of
    the module is missing from the checkpoint."""
    targets = flax_targets(module)
    converted, unused = {}, []
    for key, w in state_dict.items():
        path = _torch_key_to_path(key)
        if path is None or path not in targets:
            unused.append(key)
        else:
            converted[path] = (key, w)
    return state_with(module, converted, ((),)), unused
