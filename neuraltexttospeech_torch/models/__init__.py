"""FastPitch (inference) and the HiFi-GAN generator."""
