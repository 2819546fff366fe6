"""Python wrappers of the hand-written CUDA kernels in ``csrc/``.

Each module holds a kernel's plain PyTorch version, its CUDA wrapper and
the dispatch between them (CPU tensor -> plain, CUDA tensor -> kernel).
"""


def all_kernels():
    """Every ported kernel, in port order (B1-B7), then the bf16 modes of
    B1 and B2, then the z-halo modes of B5 and B6 and the z-pad mode of
    B7, then the z-halo modes of B1-B4, then the bf16 z-halo modes of B1
    and B2, then the Taylor squaring's forward T1 and backward T2, then the
    residual map's forward L1 and backward L2."""
    from .block_warp import B3, B3Z, B4, B4Z
    from .lcn_residual import L1, L2
    from .split_warp import B1, B1_BF16, B1Z, B1Z_BF16, B2, B2_BF16, B2Z, B2Z_BF16
    from .taylor_square import T1, T2
    from .warp_bounded import B5, B5Z, B6, B6Z, B7, B7Z

    return [B1, B2, B3, B4, B5, B6, B7, B1_BF16, B2_BF16, B5Z, B6Z, B7Z, B1Z, B2Z, B3Z, B4Z,
            B1Z_BF16, B2Z_BF16, T1, T2, L1, L2]
