"""Offline preprocess jobs: dataset conversion, tar packing, caption generation."""
