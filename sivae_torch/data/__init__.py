"""Synthetic data, preprocessing and the grouped split."""
