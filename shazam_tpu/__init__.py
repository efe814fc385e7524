"""shazam-tpu: an accelerator-native audio-fingerprinting framework.

A ground-up JAX/XLA rebuild of the capabilities of CarlosArturoMe/shazam
("SIA"): Shazam-style audio identification with STFT constellation
fingerprints, a device-resident hash index, and offset-histogram
matching — designed for accelerator meshes (an NVIDIA GPU, or several)
instead of a SQL server.
"""

from .config import FingerprintConfig, DEFAULT_CONFIG

__version__ = "0.1.0"

__all__ = ["SIA", "FingerprintConfig", "DEFAULT_CONFIG", "__version__"]


def __getattr__(name):  # PEP 562 — keep light imports light
    """``SIA`` loads lazily: ``shazam_tpu.client`` (the HTTP SDK) and
    ``shazam_tpu.config`` must import without pulling JAX onto client
    machines; ``from shazam_tpu import SIA`` still works unchanged."""
    if name == "SIA":
        from .api import SIA

        return SIA
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
