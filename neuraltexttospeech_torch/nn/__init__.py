"""Shared layers, the FFT transformer stack, flax-exact weight and spectral
norm, and the MSD's folded grouped conv (``fastconv``)."""
