"""Python wrappers of the hand-written CUDA kernels in ``csrc/``.

Each module holds a kernel's plain PyTorch version, its CUDA wrapper and
the dispatch between them (CPU tensor -> plain, CUDA tensor -> kernel).
"""


def all_kernels():
    """Every ported kernel, in port order (B1-B7), then the z-halo modes of
    B5 and B6."""
    from .block_warp import B3, B4
    from .split_warp import B1, B2
    from .warp_bounded import B5, B5Z, B6, B6Z, B7

    return [B1, B2, B3, B4, B5, B6, B7, B5Z, B6Z]
