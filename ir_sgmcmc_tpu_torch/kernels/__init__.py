"""Python wrappers of the hand-written CUDA kernels in ``csrc/``.

Each module holds a kernel's plain PyTorch version, its CUDA wrapper and
the dispatch between them (CPU tensor -> plain, CUDA tensor -> kernel).
"""


def all_kernels():
    """The kernels of the main path, in port order (B1-B4)."""
    from .block_warp import B3, B4
    from .split_warp import B1, B2

    return [B1, B2, B3, B4]
