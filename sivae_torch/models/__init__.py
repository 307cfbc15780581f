"""Spatial-latent model family: blocks, encoder/decoder, registry."""
