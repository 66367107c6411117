"""AutoencoderKL: the diffusers kl-f8 first stage.

Port of ``dfot_tpu/vae/autoencoder_kl.py``: diffusers' AutoencoderKL is the
CompVis KL autoencoder of :mod:`.image_vae`, so :class:`AutoencoderKL` is an
alias with the kl-f8 layout (:data:`KL_F8_CONFIG`: stride 8, 4 latent
channels), and :func:`diffusers_state_dict` renames a diffusers state dict
(``sd-vae-ft-*``, kl-f8) onto the port's ImageVAE names: the weights that
``import_diffusers_vae_params`` (``dfot_tpu/vae/autoencoder_kl.py:58``)
gives the JAX package's module.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from .image_vae import ImageVAE, ImageVAEConfig

__all__ = ["AutoencoderKL", "KL_F8_CONFIG", "diffusers_state_dict"]

KL_F8_CONFIG = ImageVAEConfig(
    in_channels=3, out_ch=3, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
    attn_resolutions=(), dropout=0.0, resolution=256, z_channels=4, double_z=True, embed_dim=4,
)


class AutoencoderKL(ImageVAE):
    """The ImageVAE with the standard kl-f8 layout by default."""

    def __init__(self, cfg: ImageVAEConfig = KL_F8_CONFIG):
        super().__init__(cfg)


_RESNET = {"norm1": "norm1", "conv1": "conv1", "norm2": "norm2", "conv2": "conv2",
           "conv_shortcut": "nin_shortcut", "nin_shortcut": "nin_shortcut"}
_ATTN = {"to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out", "group_norm": "norm"}


def _rename(key: str, n_levels: int) -> str:
    side, rest = key.split(".", 1)
    if side in ("quant_conv", "post_quant_conv"):
        return key
    m = re.fullmatch(r"(conv_in|conv_out)\.(weight|bias)", rest)
    if m:
        return f"{side}.{rest}"
    m = re.fullmatch(r"conv_norm_out\.(weight|bias)", rest)
    if m:
        return f"{side}.norm_out.{m.group(1)}"
    m = re.fullmatch(r"mid_block\.resnets\.(\d)\.(\w+)\.(weight|bias)", rest)
    if m:
        return f"{side}.mid_block_{int(m.group(1)) + 1}.{_RESNET[m.group(2)]}.{m.group(3)}"
    m = re.fullmatch(r"mid_block\.attentions\.0\.(.+)\.(weight|bias)", rest)
    if m:
        return f"{side}.mid_attn.{_ATTN[m.group(1)]}.{m.group(2)}"
    m = re.fullmatch(r"down_blocks\.(\d+)\.resnets\.(\d+)\.(\w+)\.(weight|bias)", rest)
    if m and side == "encoder":
        return f"encoder.down_{m.group(1)}_{m.group(2)}.{_RESNET[m.group(3)]}.{m.group(4)}"
    m = re.fullmatch(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(weight|bias)", rest)
    if m and side == "encoder":
        return f"encoder.downsample_{m.group(1)}.conv.{m.group(2)}"
    # diffusers orders the decoder's up blocks from the top: index d is level n - 1 - d
    m = re.fullmatch(r"up_blocks\.(\d+)\.resnets\.(\d+)\.(\w+)\.(weight|bias)", rest)
    if m and side == "decoder":
        i = n_levels - 1 - int(m.group(1))
        return f"decoder.up_{i}_{m.group(2)}.{_RESNET[m.group(3)]}.{m.group(4)}"
    m = re.fullmatch(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(weight|bias)", rest)
    if m and side == "decoder":
        return f"decoder.upsample_{n_levels - 1 - int(m.group(1))}.conv.{m.group(2)}"
    raise KeyError(f"unmapped diffusers key {key}")


def diffusers_state_dict(state: Mapping) -> Dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict -> the port's ImageVAE state dict
    (attention projections that diffusers holds as 1x1 convs squeezed to
    linear weights)."""
    ups = [int(m.group(1)) for k in state if (m := re.match(r"decoder\.up_blocks\.(\d+)\.", k))]
    n_levels = 1 + max(ups)
    out = {}
    for key, value in state.items():
        name = _rename(key, n_levels)
        t = torch.as_tensor(value, dtype=torch.float32)
        if ".mid_attn." in name and name.endswith("weight") and t.ndim == 4 \
                and not name.endswith("norm.weight"):
            t = t[:, :, 0, 0]
        out[name] = t.contiguous()
    return out
