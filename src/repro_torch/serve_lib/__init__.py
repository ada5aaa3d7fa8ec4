"""Serving of the port: batched prefill + greedy decode."""
