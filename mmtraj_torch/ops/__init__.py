"""Kernel wrappers (CUDA C++ in ``csrc/``) beside their plain PyTorch versions."""


def launch_counters() -> dict:
    """Each kernel's wrapper by name; its ``launches`` attribute counts the
    launches of its kernel (Python calls that reach the kernel).  A
    lane-batched launch of ``csrc/gat.cu`` counts in ``fused_gat_lanes`` and,
    as a launch of the same kernel, in ``fused_gat``; one of ``csrc/wgrad.cu``
    in ``weight_grad_lanes``; a call of ``csrc/gat_grad.cu`` (its three
    launches) in ``fused_gat_grad``; a forward of ``csrc/layer_norm.cu`` in
    ``fused_layer_norm``, a backward (its two launches) in
    ``fused_layer_norm_grad``."""
    from mmtraj_torch.ops import (dense_grad, fused_attend, fused_decoder, fused_gat,
                                  fused_layer_norm)

    return {"attend": fused_attend.attend, "attend_packed": fused_attend.attend_packed,
            "fused_gat": fused_gat.fused_gat, "fused_gat_lanes": fused_gat.fused_gat_lanes,
            "fused_gat_grad": fused_gat.fused_gat_grad,
            "fused_decode": fused_decoder.fused_decode,
            "weight_grad_lanes": dense_grad.weight_grad_lanes,
            "fused_layer_norm": fused_layer_norm.fused_layer_norm,
            "fused_layer_norm_grad": fused_layer_norm.fused_layer_norm_grad}
