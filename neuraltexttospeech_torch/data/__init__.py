"""Filelist parsing and WAV IO, the vocoder dataset, batch prefetching."""
