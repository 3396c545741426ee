"""Serving for the port: the batching InferenceEngine, the ServingFrontend
over engines, the socket RPC and engine worker processes."""
