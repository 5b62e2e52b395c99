"""Serving plane of the port: InferenceExecutor and GPT-2 decode."""
from .executor import InferenceExecutor, default_buckets
from .router import ServeRejected
from .decode import DecodeEngine, DecodeRouter, DecodeStream
