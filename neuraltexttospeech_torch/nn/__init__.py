"""Shared layers and the FFT transformer stack."""
