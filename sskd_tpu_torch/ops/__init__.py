"""Tensor operations of the port and the wrappers of its CUDA kernels.

Each kernel wrapper keeps a ``launches`` count that grows by one where it
launches its kernel and nowhere else; ``launch_counts`` reads them and
``reset_launch_counts`` sets them to 0, so a run can show which kernels its
path went through. A wrapper with more than one kernel route also counts the
launches of its tensor-core route in ``tc_launches`` (``tc_launch_counts``),
a top-k wrapper those of its bf16 route in ``bf16_launches``
(``bf16_launch_counts``), an attention wrapper its launches by head dim in
``head_dim_launches`` (``head_dim_launch_counts``), ``dropattn_bwd`` those
of its streaming route in ``stream_launches`` and those on its three-pass
kernel in ``three_pass_launches``, and ``bin_gather`` those of its f32
tensor-core route in ``f32_tc_launches`` and, of them, those over pairs
sorted by bin in ``sorted_launches``.
"""

from __future__ import annotations


def kernel_wrappers() -> dict:
    """Kernel name -> wrapper function."""
    from sskd_tpu_torch.ops.attention import dropattn_bwd, dropattn_fwd, flash_attention
    from sskd_tpu_torch.ops.topk_cluster import cell_gather, cell_gather_b1
    from sskd_tpu_torch.ops.topk_kernels import bin_gather, binmax, binmax_strided

    return {
        "binmax": binmax,
        "bin_gather": bin_gather,
        "flash_attn_fwd": flash_attention,
        "dropattn_fwd": dropattn_fwd,
        "dropattn_bwd": dropattn_bwd,
        "binmax_strided": binmax_strided,
        "cell_gather": cell_gather,
        "cell_gather_b1": cell_gather_b1,
    }


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def tc_launch_counts() -> dict[str, int]:
    """Kernel name -> launches of its tensor-core route, for the wrappers
    that have one."""
    return {name: fn.tc_launches for name, fn in kernel_wrappers().items()
            if hasattr(fn, "tc_launches")}


def bf16_launch_counts() -> dict[str, int]:
    """Kernel name -> launches of its bf16 route, for the wrappers that have
    one."""
    return {name: fn.bf16_launches for name, fn in kernel_wrappers().items()
            if hasattr(fn, "bf16_launches")}


def head_dim_launch_counts() -> dict[str, dict[int, int]]:
    """Kernel name -> {head dim: launches}, for the attention wrappers."""
    return {name: dict(fn.head_dim_launches) for name, fn in kernel_wrappers().items()
            if hasattr(fn, "head_dim_launches")}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        for extra in ("tc_launches", "bf16_launches", "stream_launches",
                      "three_pass_launches", "f32_tc_launches", "sorted_launches"):
            if hasattr(fn, extra):
                setattr(fn, extra, 0)
        if hasattr(fn, "head_dim_launches"):
            fn.head_dim_launches = {}
