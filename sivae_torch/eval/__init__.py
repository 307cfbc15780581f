"""Evaluation: batch encoding, retrieval, reconstruction quality."""
