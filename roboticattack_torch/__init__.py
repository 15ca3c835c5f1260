"""PyTorch + CUDA port of roboticattack_tpu, for one NVIDIA H100.

The JAX package `roboticattack_tpu` stays the reference each part of the port
is held against. This package imports torch, never jax, and nothing of the
JAX package. Its entry points run on CUDA unless the caller passes
device="cpu".
"""


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error raised for an option whose code is not ported yet; `item`
    names its ROADMAP.md entry (queue A, "slice N: name")."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md queue A, {item})"
    )
