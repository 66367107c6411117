"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops.attention``, ``ops.qkv_prep``, ``ops.ln_modulate`` and
``ops.ring_attention`` are the modules;
their wrappers are re-exported here under names that do not shadow them.
"""

from .attention import (
    attention_backward_reference,
    attention_reference,
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dkv_wide,
    flash_bwd_dq,
    flash_bwd_dq_wide,
    flash_fwd_wide,
    small_n_attention,
    small_n_attention_reference,
    small_n_attention_wide,
)
from .ln_modulate import ln_modulate_bwd, reference_ln_modulate, reference_ln_modulate_bwd
from .ln_modulate import ln_modulate as _ln_modulate
from .qkv_prep import (
    attention_from_packed_qkv,
    attn_out_collect,
    attn_out_scatter,
    fold_qk_tables,
    qkv_prep_bwd,
    reference_qkv_prep,
    signed_sin,
    swap_pairs,
)
from .qkv_prep import qkv_prep as _qkv_prep
from .ring_attention import (
    ring_dkv_hop,
    ring_dkv_hop_wide,
    ring_dq_hop,
    ring_dq_hop_wide,
    ring_fwd_hop,
    ring_fwd_hop_wide,
)

# every kernel wrapper of the package; each carries a ``launches`` count
KERNEL_WRAPPERS = {
    "flash_fwd": flash_attention,
    "qkv_prep": _qkv_prep,
    "attn_out_collect": attn_out_collect,
    "flash_bwd_dq": flash_bwd_dq,
    "flash_bwd_dkv": flash_bwd_dkv,
    "qkv_prep_bwd": qkv_prep_bwd,
    "attn_out_scatter": attn_out_scatter,
    "ln_modulate": _ln_modulate,
    "ln_modulate_bwd": ln_modulate_bwd,
    "small_n_attn": small_n_attention,
    "ring_fwd": ring_fwd_hop,
    "ring_dq": ring_dq_hop,
    "ring_dkv": ring_dkv_hop,
    # the wide family (csrc/flash_wide.cu): B1, B4, B5 and their ring entries
    # at head dims above 256
    "flash_fwd_wide": flash_fwd_wide,
    "flash_bwd_dq_wide": flash_bwd_dq_wide,
    "flash_bwd_dkv_wide": flash_bwd_dkv_wide,
    "ring_fwd_wide": ring_fwd_hop_wide,
    "ring_dq_wide": ring_dq_hop_wide,
    "ring_dkv_wide": ring_dkv_hop_wide,
    # B10's wide entry (csrc/small_n_attn.cu): short rows at head dims above
    # 256, the head streamed in 64-lane chunks
    "small_n_attn_wide": small_n_attention_wide,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
