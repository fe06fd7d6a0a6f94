"""Inference session (training comes with ROADMAP item A.3)."""

from .inference import InferenceSession
