"""Filelist parsing and WAV IO."""
