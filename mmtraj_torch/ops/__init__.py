"""Kernel wrappers (CUDA C++ in ``csrc/``) beside their plain PyTorch versions."""


def launch_counters() -> dict:
    """Each kernel's wrapper by name; its ``launches`` attribute counts the
    launches of its kernel (Python calls that reach the kernel)."""
    from mmtraj_torch.ops import fused_attend, fused_decoder, fused_gat

    return {"attend": fused_attend.attend, "attend_packed": fused_attend.attend_packed,
            "fused_gat": fused_gat.fused_gat, "fused_decode": fused_decoder.fused_decode}
