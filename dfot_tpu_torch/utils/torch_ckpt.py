"""Upstream checkpoints -> state dicts the port's modules load as they are.

The reference publishes checkpoints (e.g. ``DFoT_RE10K.ckpt``) as Lightning
files whose ``state_dict`` keys read ``diffusion_model.model.*`` (only the
denoiser is saved), with optional ``_orig_mod.`` segments from
``torch.compile`` and the EMA weights in ``optimizer_states[0]["ema"]``, a
list in the order of the model's keys. The port's modules keep the upstream
parameter names, so after the surgery of :func:`strip_checkpoint` (the JAX
package's ``dfot_tpu/utils/torch_ckpt.py:54``) the result loads with
``model.load_state_dict(state, strict=True)``, with no importer: the
Fourier noise embedding's ``freqs`` and ``phases`` buffers come in with it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["load_state_dict", "strip_checkpoint"]


def load_state_dict(path: str) -> Dict[str, Any]:
    """The object a ``.ckpt``, ``.pt`` or ``.pth`` file holds, loaded onto
    the CPU, or a ``.safetensors`` file's tensors (where the ``safetensors``
    package is installed). A Lightning checkpoint holds more than tensors,
    so it is unpickled in full, as the JAX package loads it: load only
    checkpoints you trust."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"reading {path} needs the safetensors package") from e
        return dict(load_file(path))
    if not path.endswith((".ckpt", ".pt", ".pth")):
        raise ValueError(f"not a torch checkpoint file: {path}")
    return torch.load(path, map_location="cpu", weights_only=False)


def strip_checkpoint(ckpt: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's checkpoint surgery: promote the EMA weights, keep the
    denoiser's ``diffusion_model.model.*`` keys without that prefix, drop
    ``_orig_mod.`` segments. Floating tensors come back as fp32."""
    state = ckpt.get("state_dict", ckpt)
    opt_states = ckpt.get("optimizer_states")
    if opt_states and "ema" in opt_states[0]:
        ema = opt_states[0]["ema"]
        keys = [k for k in state if _is_model_key(k)]
        if len(keys) != len(ema):
            raise ValueError(
                f"EMA weight count mismatch: {len(ema)} EMA tensors for {len(keys)} model keys")
        state = dict(state)
        for k, v in zip(keys, ema):
            state[k] = v

    out = {}
    for key, value in state.items():
        key = key.replace("_orig_mod.", "")
        if not _is_model_key(key):
            continue
        key = key.split("diffusion_model.model.", 1)[-1]
        value = torch.as_tensor(value).detach()
        out[key] = value.float() if value.is_floating_point() else value
    return out


def _is_model_key(key: str) -> bool:
    return "diffusion_model.model" in key or not (
        "." in key and key.split(".")[0] in ("vae", "metrics", "registry")
    )
