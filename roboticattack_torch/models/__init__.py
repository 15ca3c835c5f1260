"""Models of the port: configs, vision towers, projector, Llama stack,
quantization, greedy action decode, and the JAX weight bridge."""

from .config import OPENVLA_7B, REGISTRY, VLA_TINY, VLAConfig, get_config

__all__ = ["OPENVLA_7B", "REGISTRY", "VLA_TINY", "VLAConfig", "get_config"]
