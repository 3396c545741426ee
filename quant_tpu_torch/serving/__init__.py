"""Serving for the port: the batching InferenceEngine."""
