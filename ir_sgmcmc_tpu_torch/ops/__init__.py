"""Tensor operators: grids, stencils, Sobolev smoothing, resampling."""
